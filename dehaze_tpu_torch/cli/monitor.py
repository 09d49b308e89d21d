"""Host CPU/RAM monitor (counterpart of `dehaze_tpu/cli/monitor.py`; ≙
`LOG_USE_CPU_MEMORY/use_memory.py`).

    python -m dehaze_tpu_torch.cli.monitor [--interval 20] [--log f.txt]
"""

import argparse

from dehaze_tpu_torch.utils.monitor import monitor_loop


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="cpu/ram monitor")
    p.add_argument("--interval", type=float, default=20.0)
    p.add_argument("--log", default=None)
    p.add_argument("--count", type=int, default=None,
                   help="stop after N samples (default: run forever, like "
                        "the reference's use_memory.py)")
    a = p.parse_args(argv)
    monitor_loop(interval=a.interval, log_path=a.log, max_iters=a.count)
    return 0


if __name__ == "__main__":
    main()
