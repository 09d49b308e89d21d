"""Sustained-throughput streaming inference: decode → device → encode with
overlap (counterpart of `dehaze_tpu/infer/stream.py`).

The reference's whole-image script is strictly serial (read, forward,
write per frame), so the card idles during host IO. This runner pipelines
the three stages with two thread pools:

    decode pool ──> forward (at most 2 frames in flight) ──> encode pool

Frames are grouped by geometry; each distinct (H, W) builds one forward.
On the card the host queues a frame's kernels and its device-to-host copy
(into pinned memory) and goes on; it waits only for the oldest of the
frames in flight, on that frame's event, before handing it to an encoder.

With `data_parallel` (`--data_axis N`: one process per GPU under torchrun)
each rank streams its share of the frames (`infer.sharded.frame_share`)
through the same pipeline, on its own device; the stats are summed over
the ranks, and the sustained rate is every rank's pixels over the slowest
rank's wall time, from a common start.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from dehaze_tpu_torch.infer.sharded import frame_share
from dehaze_tpu_torch.infer.tiled import (make_native_image_fn,
                                          make_whole_image_fn, quantize_u8)
from dehaze_tpu_torch.parallel import dist


def _decoded_frames(frames, dec, load_fn, lookahead, waits=None):
    """Yield (decoded_img, out_path) with at most `lookahead` decode
    futures outstanding: bounded host memory even on huge folders (a
    whole-folder submit would keep every float32 frame, ~23 MB each).
    Appends the seconds spent waiting for each frame to `waits`."""
    decoded = deque(dec.submit(load_fn, p) for p, _ in frames[:lookahead])
    next_submit = lookahead
    for _, out_path in frames:
        fut = decoded.popleft()
        if next_submit < len(frames):
            decoded.append(dec.submit(load_fn, frames[next_submit][0]))
            next_submit += 1
        t0 = time.perf_counter()
        img = fut.result()
        if waits is not None:
            waits.append(time.perf_counter() - t0)
        yield img, out_path


def _timed(fn, secs: list):
    """fn, appending the seconds of each call to `secs` (thread-safe)."""
    def call(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            secs.append(time.perf_counter() - t0)
    return call


def _fetch(out: torch.Tensor):
    """Queue the copy of a device result to the host; (host tensor, event
    that marks it done, or None on the CPU)."""
    if out.device.type != "cuda":
        return out, None
    host = out.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))
    return host, done


def stream_dehaze(
    apply_fn: Optional[Callable[[torch.Tensor], torch.Tensor]],
    frames: Iterable[Tuple[str, str]],  # (input_path, output_path)
    ps: int = 128,
    square: bool = False,
    decode_workers: int = 2,
    encode_workers: int = 2,
    load_fn: Optional[Callable[[str], np.ndarray]] = None,
    save_fn: Optional[Callable[[str, np.ndarray], None]] = None,
    data_parallel: bool = False,
    base_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    base_hw: Optional[Tuple[int, int]] = None,
    device="cuda",
    native: bool = False,
) -> Dict[str, float]:
    """Dehaze a stream of frames with decode/compute/encode overlap.

    Returns {"frames": n, "mpix_s": sustained Mpix/s, "sec": wall} and
    the time split, in seconds summed over the frames: "decode" and
    "encode" (busy time of the worker pools), "queue" (the host issuing
    the forwards), "wait_card" (the host waiting for the oldest frame in
    flight) and "wait_decode" (the host waiting for a decoded frame).
    Decode runs at most `decode_workers + 2` frames ahead; encode is
    fire-and-forget (joined before returning). `square=False` uses the
    rectangular wrap-pad canvas (the same crop, less compute); True the
    reference's square one; `native=True` runs each frame at its own
    resolution with no canvas (FFA-Net's protocol). `device` is where
    `apply_fn`'s forwards run (the card unless the caller asks for the
    CPU).

    With `base_fn` + `base_hw`, the prebuilt fixed-geometry forward (an
    artifact from `infer.export.load_exported`) replaces apply_fn and
    every frame must match `base_hw`: artifacts bake one geometry, and
    serve in one process, as in the JAX package.

    With `data_parallel`, every rank passes the same `frames` and streams
    its share; every rank returns the stats of all of them.
    """
    if data_parallel and base_fn is not None:
        raise ValueError("an exported artifact serves single-device: "
                         "stream it without --data_axis, or serve from "
                         "--weights")
    if data_parallel:
        frames = list(frames)
        frames = [frames[i] for i in frame_share(len(frames))]
        dist.barrier()  # a common start for the sustained rate
        stats = stream_dehaze(apply_fn, frames, ps, square, decode_workers,
                              encode_workers, load_fn, save_fn,
                              device=device, native=native)
        parts = dist.gather_objects(stats)
        summed = {k: sum(p[k] for p in parts) for k in stats}
        summed["sec"] = max(p["sec"] for p in parts)
        # every rank's megapixels (mpix_s · sec) over the slowest wall
        summed["mpix_s"] = sum(p["mpix_s"] * p["sec"] for p in parts) / \
            summed["sec"]
        return summed
    if load_fn is None:
        from dehaze_tpu_torch.data.images import load_img as load_fn
    if save_fn is None:
        from dehaze_tpu_torch.data.images import save_img as save_fn

    frames = list(frames)
    split = {k: [] for k in ("decode", "encode", "queue", "wait_card",
                             "wait_decode")}
    if not frames:
        return {"frames": 0, "mpix_s": 0.0, "sec": 0.0,
                **{k: 0.0 for k in split}}
    load_fn = _timed(load_fn, split["decode"])
    save_fn = _timed(save_fn, split["encode"])

    runs: Dict[Tuple[int, int], Callable] = {}

    def get_run(h: int, w: int):
        if (h, w) not in runs:
            if base_fn is not None:
                if (h, w) != tuple(base_hw):
                    raise ValueError(
                        f"frame is {h}x{w} but the exported artifact bakes "
                        f"{base_hw[0]}x{base_hw[1]}; re-export for this "
                        "geometry")
                base = base_fn
            elif native:
                base = make_native_image_fn(apply_fn, device=device)
            else:
                base = make_whole_image_fn(apply_fn, h, w, ps, square=square,
                                           device=device)
            runs[(h, w)] = quantize_u8(base)
        return runs[(h, w)]

    total_pix = 0
    n = 0
    lookahead = decode_workers + 2  # bounded: host RAM stays O(lookahead)
    with cf.ThreadPoolExecutor(decode_workers) as dec, \
            cf.ThreadPoolExecutor(encode_workers) as enc:
        pending: deque = deque()  # (host out, event, out_path): at most 2
        enc_futs = []

        def hand_over():
            host, done, path = pending.popleft()
            t1 = time.perf_counter()
            if done is not None:
                done.synchronize()  # that frame only
            split["wait_card"].append(time.perf_counter() - t1)
            enc_futs.append(enc.submit(save_fn, path, host[0].numpy()))

        t0 = time.perf_counter()
        for img, out_path in _decoded_frames(frames, dec, load_fn, lookahead,
                                             split["wait_decode"]):
            h, w = img.shape[:2]
            t1 = time.perf_counter()
            out = get_run(h, w)(img[None])  # queued on the card
            pending.append(_fetch(out) + (out_path,))
            split["queue"].append(time.perf_counter() - t1)
            total_pix += h * w
            n += 1
            while len(pending) > 2:
                hand_over()
        while pending:
            hand_over()
        for f in enc_futs:
            f.result()
        dt = time.perf_counter() - t0
    return {"frames": n, "mpix_s": total_pix / 1e6 / dt, "sec": dt,
            **{k: sum(v) for k, v in split.items()}}
