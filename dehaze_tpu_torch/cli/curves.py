"""Training curves from structured run logs (counterpart of
`dehaze_tpu/cli/curves.py`).

Every trainer writes `{stamp}.jsonl` event logs (`utils.logging`); this
CLI turns one run directory, including a resumed run spread across many
trainer processes, into PSNR/SSIM against epoch, the train loss, the
throughput and a memory panel, and optionally the merged per-epoch CSV.
It reads the port's logs and the JAX package's alike. The memory column
and panel name what the logs hold: the port logs the card's peak
allocated memory (`peak_mem_gib`, CUDA runs only), the JAX package the
host's RSS (`rss_gb`).

    python -m dehaze_tpu_torch.cli.curves --log_dir LOG/uformer_ \\
        --out curves.png [--csv curves.csv]

Merging rule: events from later segments (sorted stamps) win on the
(kind, epoch, iter) key, so a resume that re-runs a partial epoch
supersedes the crashed segment's events; a torn last line of a killed
writer is skipped. --out '' writes no figure (which needs matplotlib).
"""

import argparse
import csv
import glob
import json
import os

from dehaze_tpu_torch.utils.plot import pyplot

# (event key, panel title, unit) of each memory quantity a log may hold
MEMORY = (("rss_gb", "host RSS (per segment)", "GB"),
          ("peak_mem_gib", "peak device memory (allocated)", "GiB"))


def load_events(log_dir: str):
    """Merge all *.jsonl segments; later segments win on duplicate keys."""
    paths = sorted(glob.glob(os.path.join(log_dir, "*.jsonl")))
    if not paths:
        raise SystemExit(f"no .jsonl run logs under {log_dir}")
    merged = {}
    for path in paths:  # sorted stamps = chronological segments
        with open(path) as f:
            for ln in f:
                try:
                    d = json.loads(ln)
                except json.JSONDecodeError:
                    continue  # torn tail line from a killed writer
                merged[(d.get("kind"), d.get("epoch"), d.get("iter"))] = d
    events = sorted(merged.values(),
                    key=lambda d: (d.get("epoch", 0), d.get("iter", 0)))
    return events, len(paths)


def series(events):
    """(epoch events, the best-PSNR eval of each epoch), by epoch."""
    epochs = [d for d in events if d["kind"] == "epoch"]
    best_eval = {}
    for d in events:
        if d["kind"] != "eval":
            continue
        e = d["epoch"]
        if e not in best_eval or d["psnr"] > best_eval[e]["psnr"]:
            best_eval[e] = d
    return epochs, [best_eval[e] for e in sorted(best_eval)]


def memory_keys(epochs):
    """The MEMORY entries that some epoch event holds."""
    return [m for m in MEMORY if any(m[0] in d for d in epochs)]


def write_csv(path: str, epochs, evals) -> None:
    mem = [m[0] for m in memory_keys(epochs)]
    ev_by_epoch = {d["epoch"]: d for d in evals}
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["epoch", "loss", "img_per_s"] + mem + ["psnr", "ssim"])
        for d in epochs:
            ev = ev_by_epoch.get(d["epoch"], {})
            w.writerow([d["epoch"], d["loss"], d.get("img_per_s", "")]
                       + [d.get(k, "") for k in mem]
                       + [ev.get("psnr", ""), ev.get("ssim", "")])


def plot(out: str, title: str, epochs, evals) -> None:
    plt = pyplot(f"the curves figure {out}")
    fig, axes = plt.subplots(2, 2, figsize=(11, 7), constrained_layout=True)
    ee = [d["epoch"] for d in evals]
    axes[0, 0].plot(ee, [d["psnr"] for d in evals], "-o", ms=2.5)
    axes[0, 0].set(title="val PSNR (best eval per epoch)", xlabel="epoch",
                   ylabel="dB")
    ax2 = axes[0, 0].twinx()
    ax2.plot(ee, [d["ssim"] for d in evals], color="tab:orange", alpha=0.5)
    ax2.set_ylabel("SSIM", color="tab:orange")
    te = [d["epoch"] for d in epochs]
    axes[0, 1].semilogy(te, [d["loss"] for d in epochs])
    axes[0, 1].set(title="train loss", xlabel="epoch")
    axes[1, 0].plot(te, [d.get("img_per_s") for d in epochs])
    axes[1, 0].set(title="throughput", xlabel="epoch", ylabel="img/s")
    mem = memory_keys(epochs)
    for key, label, unit in mem:
        axes[1, 1].plot(te, [d.get(key) for d in epochs], label=label)
    axes[1, 1].set(title=" / ".join(m[1] for m in mem) or
                   "no memory in the logs", xlabel="epoch",
                   ylabel=" / ".join(m[2] for m in mem))
    fig.suptitle(title)
    fig.savefig(out, dpi=110)
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="training curves from run logs")
    p.add_argument("--log_dir", required=True,
                   help="trainer log dir holding {stamp}.jsonl segments")
    p.add_argument("--out", default="curves.png",
                   help="the figure ('' for none; needs matplotlib)")
    p.add_argument("--csv", default=None,
                   help="also write the merged per-epoch table")
    args = p.parse_args(argv)

    events, n_segments = load_events(args.log_dir)
    epochs, evals = series(events)
    if not epochs and not evals:
        raise SystemExit("run logs contain no epoch/eval events")
    if args.csv:
        write_csv(args.csv, epochs, evals)
    if args.out:
        title = (f"{os.path.basename(os.path.normpath(args.log_dir))} — "
                 f"{len(epochs)} epochs across {n_segments} segments")
        try:
            plot(args.out, title, epochs, evals)
        except ImportError as e:
            raise SystemExit(str(e)) from e
    best = max(evals, key=lambda d: d["psnr"]) if evals else None
    print(f"{len(epochs)} epochs, {len(evals)} eval points, {n_segments} "
          "segments" + (f"; best PSNR {best['psnr']:.4f} dB @ epoch "
                        f"{best['epoch']}" if best else ""))
    wrote = [f for f in (args.out, args.csv) if f]
    print("wrote " + (" and ".join(wrote) if wrote else "nothing"))
    return 0


if __name__ == "__main__":
    main()
