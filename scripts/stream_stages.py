#!/usr/bin/env python3
"""Where a stream's time goes, on one NVIDIA GPU: `infer.stream.stream_dehaze`
in process on synthetic 1200×1600 PNG frames, Uformer-32 (seeded random
init, bf16, rect canvas).

    python3 scripts/stream_stages.py [--frames 12] [--reps 2]

Runs the stream with live weights (uint8 and float32 decode) and with an
artifact exported in process (`infer.export`), in turns, `--reps` times
each after one warm-up stream; then each without an encoder (the forward's
pace) and with four encoders; then the forward and fetch alone, frame
after frame. One line per run: s/frame, Mpix/s and the stream's time split
(decode and encode busy seconds of the worker pools, the host queuing the
forwards, its waits for the card and for decoded frames), then a JSON
line of the same. Prints the card's name and power limit first. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = (1200, 1600)
SEED = 1234
SPLIT = ("decode", "queue", "wait_card", "wait_decode", "encode")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.data.images import load_img, save_img
    from dehaze_tpu_torch.data.synth import make_scene
    from dehaze_tpu_torch.infer import export as E
    from dehaze_tpu_torch.infer.stream import stream_dehaze
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn, quantize_u8
    from dehaze_tpu_torch.models.uformer import Uformer, draw_sample_tables

    if not torch.cuda.is_available():
        sys.exit("stream_stages.py needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp()
    src = os.path.join(tmp, "in")
    os.makedirs(src)
    for i in range(args.frames):
        rng = np.random.default_rng(100 + i)
        hazy = make_scene(rng, FRAME)[1] * 255.0
        hazy += rng.normal(0.0, 2.0, size=hazy.shape)
        save_img(os.path.join(src, f"{i:03d}.png"),
                 np.clip(hazy + 0.5, 0, 255).astype(np.uint8))
    names = sorted(os.listdir(src))
    torch.manual_seed(SEED)
    model = Uformer(ModelConfig(), device="cuda").eval()

    def apply_fn(x):
        return model(x, generator=torch.Generator().manual_seed(SEED))

    art = os.path.join(tmp, "rect.dhz")
    tables = draw_sample_tables(model, torch.Generator().manual_seed(SEED),
                                device="cuda")
    E.save_exported(art, E.export_whole_image_bytes(
        E.WholeImage(model, tables, *FRAME, 128, False), *FRAME, "cuda"),
        {"height": FRAME[0], "width": FRAME[1]})
    base_fn, _ = E.load_exported(art, "cuda")
    results = []

    def stream(label, u8, exported, encode_workers=2, encode=True):
        out = os.path.join(tmp, "out")
        os.makedirs(out, exist_ok=True)
        frames = [(os.path.join(src, n), os.path.join(out, n))
                  for n in names]
        st = stream_dehaze(
            None if exported else apply_fn, frames, ps=128,
            load_fn=partial(load_img, u8=u8),
            save_fn=save_img if encode else (lambda path, img: None),
            encode_workers=encode_workers,
            base_fn=base_fn if exported else None,
            base_hw=FRAME if exported else None)
        row = {"run": label, "s_per_frame": st["sec"] / st["frames"],
               "mpix_s": st["mpix_s"], **{k: st[k] for k in SPLIT}}
        results.append(row)
        print(f"{label}: {st['frames']} frames {row['s_per_frame']:.4f} "
              f"s/frame {st['mpix_s']:.3f} Mpix/s; split (s over the "
              "frames) " + ", ".join(f"{k} {st[k]:.3f}" for k in SPLIT),
              flush=True)

    runs = (("weights_u8", True, False), ("weights_f32", False, False),
            ("exported", False, True))
    for label, u8, exported in runs:  # warm-up: each forward's first frame
        stream(f"{label} warm-up", u8, exported)
    for rep in range(args.reps):
        for label, u8, exported in runs:
            stream(f"{label} {rep}", u8, exported)
    stream("weights_u8 no encoder", True, False, encode=False)
    stream("exported no encoder", False, True, encode=False)
    stream("weights_u8 4 encoders", True, False, encode_workers=4)
    stream("exported 4 encoders", False, True, encode_workers=4)
    imgs = [load_img(os.path.join(src, n), u8=True) for n in names]
    for label, fn, xs in (
            ("serial forward+fetch weights_u8",
             quantize_u8(make_whole_image_fn(apply_fn, *FRAME, 128,
                                             square=False)), imgs),
            ("serial forward+fetch exported", quantize_u8(base_fn),
             [i.astype(np.float32) / 255.0 for i in imgs])):
        fn(xs[0][None]).cpu()
        t0 = time.perf_counter()
        for x in xs:
            fn(x[None]).cpu()
        secs = (time.perf_counter() - t0) / len(xs)
        results.append({"run": label, "s_per_frame": secs})
        print(f"{label}: {secs:.4f} s/frame", flush=True)
    print(json.dumps({"card": card, "frames": args.frames,
                      "results": results}), flush=True)


if __name__ == "__main__":
    main()
