"""Host CPU/RAM monitor (counterpart of `dehaze_tpu/utils/monitor.py`; the
reference's `LOG_USE_CPU_MEMORY/use_memory.py:5-15`).

Reads the kernel's counters directly (psutil, which the JAX package uses,
may be missing on a GPU host), with psutil's definitions: cpu% is the
busy share of the CPU time that passed over `cpu_sample_secs` in
/proc/stat (busy = all − idle − iowait; the guest times, which user and
nice already hold, not counted twice), mem% is (MemTotal − MemAvailable)
/ MemTotal from /proc/meminfo.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple


def _cpu_times() -> Tuple[float, float]:
    """(all, busy) jiffies since boot, over every CPU."""
    with open("/proc/stat") as f:
        fields = [float(v) for v in f.readline().split()[1:]]
    fields += [0.0] * (10 - len(fields))
    user, nice, system, idle, iowait, irq, softirq, steal, guest, \
        guest_nice = fields[:10]
    total = sum(fields[:10]) - guest - guest_nice
    return total, total - idle - iowait


def cpu_percent(interval: float) -> float:
    """The busy share of all CPUs over the next `interval` seconds, in %
    (one decimal)."""
    t0, b0 = _cpu_times()
    time.sleep(interval)
    t1, b1 = _cpu_times()
    if t1 <= t0:
        return 0.0
    return round(min(max((b1 - b0) / (t1 - t0) * 100.0, 0.0), 100.0), 1)


def mem_percent() -> float:
    """(MemTotal − MemAvailable) / MemTotal in % (one decimal)."""
    info = {}
    with open("/proc/meminfo") as f:
        for ln in f:
            key, _, rest = ln.partition(":")
            info[key] = float(rest.split()[0])
    total = info["MemTotal"]
    return round((total - info["MemAvailable"]) / total * 100.0, 1)


def monitor_loop(interval: float = 20.0, cpu_sample_secs: float = 2.0,
                 log_path: Optional[str] = None, stop_event=None,
                 max_iters: Optional[int] = None) -> None:
    """Print (and optionally append) 'HH:MM:SS cpu x%  mem y%' every
    `interval` seconds. `max_iters` bounds the loop (None = run until
    stop_event / forever, the reference's behavior)."""
    fh = open(log_path, "a") if log_path else None
    done = 0
    try:
        while ((stop_event is None or not stop_event.is_set())
               and (max_iters is None or done < max_iters)):
            cpu = cpu_percent(cpu_sample_secs)
            mem = mem_percent()
            line = (f"{time.strftime('%H:%M:%S')} cpu {cpu:5.1f}%  "
                    f"mem {mem:5.1f}%")
            print(line, flush=True)
            if fh:
                fh.write(line + "\n")
                fh.flush()
            done += 1
            if max_iters is not None and done >= max_iters:
                break
            time.sleep(max(interval - cpu_sample_secs, 0))
    finally:
        if fh:
            fh.close()


def start_background_monitor(interval: float = 20.0,
                             log_path: Optional[str] = None):
    """Run the monitor in a daemon thread; returns a stop Event."""
    stop = threading.Event()
    t = threading.Thread(
        target=monitor_loop, kwargs=dict(interval=interval, log_path=log_path,
                                         stop_event=stop), daemon=True)
    t.start()
    return stop
