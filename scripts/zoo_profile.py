#!/usr/bin/env python3
"""Where a zoo model's forward spends its time on the GPU: for each model
and dtype, the wall time of a batch by CUDA events, the device time the
profiler's CUDA kernels add up to, the idle share (1 − device / wall) and
the kernels launched per forward, with the top kernels by device time.

    python3 scripts/zoo_profile.py [--models vit_ti,resnet_dnn_18]
        [--batch 128] [--reps 10]

Models are built as `chip_smoke.py` phase 17 builds them (seeded torch
init, 32², 10 classes, eval, the same patch and window cuts). Needs a
GPU; imports nothing of JAX.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from dehaze_tpu_torch.zoo import get_model

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", default="resnet_dnn_18,wideresnet_50,vgg_16,"
                   "mobilenet,vit_ti,swin_t,convit_ti")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    chip_smoke.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuts = dict(chip_smoke.ZOO_MODELS)
    for name in args.models.split(","):
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            torch.manual_seed(chip_smoke.SEED)
            model = get_model(name, num_classes=10, image_size=32, dtype=dt,
                              device="cuda", **cuts[name]).eval()
            gens = ({"dropout": torch.Generator("cuda").manual_seed(0)}
                    if "mcdo" in name else None)
            x = torch.randn(args.batch, 3, 32, 32, device="cuda")
            with torch.inference_mode():
                wall = chip_smoke.cuda_ms(lambda: model(x, generators=gens),
                                          args.reps)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.reps):
                        model(x, generators=gens)
                    torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.self_device_time_total > 0]
            dev_us = sum(e.self_device_time_total for e in events)
            n_kern = sum(e.count for e in events)
            dev = dev_us / 1e3 / args.reps
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
            tops = "; ".join(
                f"{e.key[:60]} "
                f"{e.self_device_time_total / 1e3 / args.reps:.3f} ms"
                for e in top)
            print(f"{name} {dname}: wall {wall:.3f} ms per batch of "
                  f"{args.batch}, device {dev:.3f} ms, idle "
                  f"{max(0.0, 1 - dev / wall) * 100:.1f}%, "
                  f"{n_kern / args.reps:.0f} kernels per forward; top: "
                  f"{tops}", flush=True)
            del model


if __name__ == "__main__":
    main()
