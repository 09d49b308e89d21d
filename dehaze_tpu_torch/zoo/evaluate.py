"""The zoo's calibration test harness (counterpart of
`dehaze_tpu/zoo/evaluate.py`, ≙ the reference's `ops/tests.py`).

NLL on the log of the mean softmax re-log-softmaxed (the reference feeds
`torch.log(ys_pred)` back into CrossEntropyLoss, `tests.py:92`), cutoff
confusion matrices, accuracy, unconfidence, mIoU and frequency per cutoff,
top-5, Brier, the 10-bin confidence histogram, ECE and signed ECE, and the
confidence-histogram + reliability-diagram figure. The metric primitives
are the JAX package's numpy functions, copied: the model runs on the
device, the metrics on the host.

Batches arrive as the loaders give them, NHWC numpy; `make_predict_fn`
moves a batch to the model's device and permutes it to NCHW there. The
probabilities keep the logits' dtype (float32, or bfloat16 under a bf16
model, as the JAX package's do) and reach numpy as float32: the bf16
values widen exactly, but numpy then computes in float32/float64 where
the JAX package's bfloat16 numpy array rounds each ufunc to bf16.

MC-dropout models average `n_ff` stochastic forward passes
(`tests.py:83`), their masks drawn from the `torch.Generator` given.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from dehaze_tpu_torch.ops.meters import AverageMeter


# --------------------------------------------------------------------------
# metric primitives (numpy): the reference's conventions, 1e-7 guards,
# confidence interval (min, max] in `cm`, zero rows → 0
# --------------------------------------------------------------------------

def brier(ys, ys_pred):
    """Per-sample Brier score Σ_c (1[y=c] − p_c)²."""
    return np.square(np.eye(ys_pred.shape[1])[ys] - ys_pred).sum(axis=1)


def topk(ys, ys_pred, k=5):
    """1[y ∈ top-k(p)] per sample."""
    idx = np.argpartition(ys_pred, -k, axis=1)[:, -k:]
    return (idx == np.reshape(ys, (-1, 1))).any(axis=1)


def cm(ys, ys_pred, filter_min=0.0, filter_max=1.0):
    """Confusion matrix over predictions whose confidence ∈ (min, max]."""
    num_classes = ys_pred.shape[1]
    confidence = np.amax(ys_pred, axis=1)
    pred = np.argmax(ys_pred, axis=1)
    keep = ((confidence > filter_min) & (confidence <= filter_max)
            & (ys >= 0) & (ys < num_classes))
    mat = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(mat, (ys[keep], pred[keep]), 1)
    return mat


def ious(mat):
    """Per-class IoU: diag / (row + col − diag); 0 where the union is empty."""
    mat = np.asarray(mat, dtype=float)
    inter = np.diag(mat)
    union = mat.sum(axis=0) + mat.sum(axis=1) - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def miou(mat):
    """Mean IoU over the classes that appear in the ground truth."""
    present = np.asarray(mat).sum(axis=1) > 0
    return float(ious(mat)[present].mean()) if present.any() else 0.0


def gacc(mat):
    """Global accuracy trace/total."""
    total = float(np.sum(mat))
    return float(np.trace(mat) / total) if total > 0 else 0.0


def caccs(mat):
    """Per-class accuracies diag/row (1e-7-guarded), 0 for empty rows."""
    mat = np.asarray(mat, dtype=float)
    row = mat.sum(axis=1)
    return list(np.where(row > 0, np.diag(mat) / (row + 1e-7), 0.0))


def unconfidence(cm_certain, cm_uncertain):
    """p(unconfident | inaccurate)."""
    def misses(m):
        return float(np.sum(m)) - float(np.trace(m))

    return misses(cm_uncertain) / (misses(cm_certain)
                                   + misses(cm_uncertain) + 1e-7)


def frequency(cm_certain, cm_uncertain):
    """Fraction of samples the confidence cutoff keeps."""
    n_cert = float(np.sum(cm_certain))
    return n_cert / (n_cert + float(np.sum(cm_uncertain)) + 1e-7)


def _bin_weighted_gap(count_bin, acc_bin, conf_bin, signed: bool) -> float:
    """Count-weighted (conf − acc) over the bins: |·| → ECE, raw → ECE±."""
    count = np.asarray(count_bin, dtype=float)
    gap = np.asarray(conf_bin, dtype=float) - np.asarray(acc_bin, dtype=float)
    freq = np.nan_to_num(count / (count.sum() + 1e-7))
    return float(np.sum((gap if signed else np.abs(gap)) * freq))


def ece(count_bin, acc_bin, conf_bin):
    """Expected calibration error."""
    return _bin_weighted_gap(count_bin, acc_bin, conf_bin, signed=False)


def ecse(count_bin, acc_bin, conf_bin):
    """Signed ECE ("ECE±")."""
    return _bin_weighted_gap(count_bin, acc_bin, conf_bin, signed=True)


# --------------------------------------------------------------------------
# harness
# --------------------------------------------------------------------------

def _nll(ys_pred: np.ndarray, ys, ys_soft: Optional[np.ndarray],
         smoothing: float) -> float:
    """The reference's double-softmax NLL: CrossEntropyLoss(log(p̂), target)
    == -Σ t · log_softmax(log p̂) (`tests.py:71-92`). Only target-weighted
    entries count, as in torch's CE: a p̂_c == 0 outside the target gives
    no nan; a zero in the target class gives +inf."""
    with np.errstate(divide="ignore"):
        logp = np.log(ys_pred)
    logp = logp - logp.max(axis=1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(axis=1, keepdims=True))
    c = ys_pred.shape[1]
    if ys_soft is not None and ys_soft.ndim > 1:
        t = ys_soft
    elif smoothing > 0.0:
        t = np.eye(c)[ys] * (1 - smoothing) + smoothing / c
    else:
        t = np.eye(c)[ys]
    with np.errstate(invalid="ignore"):
        weighted = np.where(t > 0, t * logp, 0.0)
    return float(np.mean(-np.sum(weighted, axis=1)))


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def to_nchw(x, device) -> torch.Tensor:
    """An NHWC batch (numpy or tensor) as an NCHW float tensor on
    `device`: moved first, permuted there."""
    x = torch.as_tensor(x).to(device)
    return x.permute(0, 3, 1, 2)


def make_predict_fn(model, n_ff: int = 1, device=None) -> Callable:
    """predict(x_nhwc, generator=None) → the mean of `n_ff` softmaxes of
    the eval-mode model's logits (`tests.py:83-84`), in the logits' dtype,
    under `torch.inference_mode()`. The generator feeds MC dropout's
    masks (`generators={"dropout": generator}`); the `n_ff` passes draw
    one after another from it."""
    dev = torch.device(device) if device is not None else _device_of(model)
    model.eval()

    def predict(x, generator: Optional[torch.Generator] = None):
        gens = None if generator is None else {"dropout": generator}
        with torch.inference_mode():
            x = to_nchw(x, dev)
            ps = [torch.softmax(model(x, generators=gens), dim=-1)
                  for _ in range(n_ff)]
            return torch.stack(ps).mean(dim=0)

    return predict


def _host(p: torch.Tensor) -> np.ndarray:
    return p.float().cpu().numpy()


def test(model, dataset: Iterable[Tuple[np.ndarray, np.ndarray]],
         n_ff: int = 1, transform: Optional[Callable] = None,
         smoothing: float = 0.0, cutoffs=(0.0, 0.9),
         bins=np.linspace(0.0, 1.0, 11), verbose: bool = False,
         period: int = 10, generator: Optional[torch.Generator] = None,
         fig_path: Optional[str] = None):
    """≙ `ops/tests.test` (`tests.py:19-149`). Returns the metric tuple
    (nll, cutoffs, cms, accs, uncs, ious, freqs, top5, brier, count_bin,
    acc_bin, conf_bin, ece, ecse); writes the confidence-histogram +
    reliability-diagram figure to fig_path if given. `transform(generator,
    xs, ys)` → (xs, soft targets) runs on the model's device, on NHWC;
    the generator (seed 0 on the CPU by default) feeds it and MC
    dropout."""
    generator = (torch.Generator().manual_seed(0) if generator is None
                 else generator)
    dev = _device_of(model)
    predict = make_predict_fn(model, n_ff)
    num_classes = None

    cms_groups = None
    cms_bin = None
    conf_acc_bin = None
    nll_meter = AverageMeter("nll")
    brier_meter = AverageMeter("brier")
    topk_meter = AverageMeter("top5")
    metrics = None

    for step, (xs, ys) in enumerate(dataset):
        ys_soft = None
        if transform is not None:
            xs, ys_soft = transform(generator, torch.as_tensor(xs).to(dev),
                                    torch.as_tensor(ys).to(dev))
            ys_soft = _host(ys_soft)
            ys = np.argmax(ys_soft, axis=-1)  # `tests.py:74`
        p = _host(predict(xs, generator))
        ys = np.asarray(ys)
        if num_classes is None:
            num_classes = p.shape[-1]
            shape = [num_classes, num_classes]
            cms_groups = [[np.zeros(shape), np.zeros(shape)]
                          for _ in cutoffs]
            cms_bin = [np.zeros(shape) for _ in range(len(bins) - 1)]
            conf_acc_bin = [0.0 for _ in range(len(bins) - 1)]

        nll_meter.update(_nll(p, ys, ys_soft, smoothing))
        topk_meter.update(topk(ys, p))
        brier_meter.update(brier(ys, p))

        for cutoff, group in zip(cutoffs, cms_groups):
            group[0] += cm(ys, p, filter_min=cutoff)
            group[1] += cm(ys, p, filter_max=cutoff)
        confidence = np.amax(p, axis=1)
        for i, (lo, hi) in enumerate(zip(bins, bins[1:])):
            cms_bin[i] += cm(ys, p, filter_min=lo, filter_max=hi)
            cond = np.logical_and(confidence >= lo, confidence < hi)
            conf_acc_bin[i] += np.sum(confidence[cond])

        accs = [gacc(c) for c, _ in cms_groups]
        iou_vals = [miou(c) for c, _ in cms_groups]
        uncs = [unconfidence(c, u) for c, u in cms_groups]
        freqs = [frequency(c, u) for c, u in cms_groups]
        count_bin = [np.sum(c) for c in cms_bin]
        acc_bin = [gacc(c) for c in cms_bin]
        conf_bin = [ca / (cnt + 1e-7)
                    for cnt, ca in zip(count_bin, conf_acc_bin)]
        metrics = (nll_meter.avg, tuple(cutoffs), cms_groups, accs, uncs,
                   iou_vals, freqs, topk_meter.avg, brier_meter.avg,
                   count_bin, acc_bin, conf_bin,
                   ece(count_bin, acc_bin, conf_bin),
                   ecse(count_bin, acc_bin, conf_bin))
        if verbose and (step + 1) % period == 0:
            print(f"{step + 1} Steps, {repr_metrics(metrics)}")

    if fig_path is not None and metrics is not None:
        save_calibration_figure(metrics, fig_path)
    return metrics


def repr_metrics(metrics) -> str:
    """≙ `tests.py:152-173`."""
    (nll_value, cutoffs, _, accs, uncs, iou_vals, freqs, topk_value,
     brier_value, _, _, _, ece_value, ecse_value) = metrics
    reprs = [
        ("NLL: %.4f" % nll_value) if nll_value > 0.01
        else ("NLL: %.4e" % nll_value),
        "Cutoffs: " + ", ".join("%.1f %%" % (c * 100) for c in cutoffs),
        "Accs: " + ", ".join("%.3f %%" % (a * 100) for a in accs),
        "Uncs: " + ", ".join("%.3f %%" % (u * 100) for u in uncs),
        "IoUs: " + ", ".join("%.3f %%" % (i * 100) for i in iou_vals),
        "Freqs: " + ", ".join("%.3f %%" % (f * 100) for f in freqs),
        "Top-5: " + "%.3f %%" % (topk_value * 100),
        "Brier: " + "%.3f" % brier_value,
        "ECE: " + "%.3f %%" % (ece_value * 100),
        "ECE±: " + "%.3f %%" % (ecse_value * 100),
    ]
    return ", ".join(reprs)


def save_calibration_figure(metrics, path: str):
    """Confidence histogram + reliability diagram (`tests.py:141-147,
    370-402`)."""
    from dehaze_tpu_torch.utils.plot import pyplot

    plt = pyplot(f"the calibration figure {path}")
    count_bin, acc_bin = metrics[9], metrics[10]
    centers = np.linspace(0.05, 0.95, 10)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    freq = np.array(count_bin) / (sum(count_bin) + 1e-7)
    axes[0].bar(centers * 100, freq * 100, width=10, color="tab:green",
                edgecolor="black", alpha=0.8)
    axes[0].set(xlim=(0, 100), ylim=(0, 100), xlabel="Confidence (%)",
                ylabel="Frequency (%)")
    guides = np.linspace(0.0, 1.0, 11)
    axes[1].plot(guides * 100, guides * 100, linestyle=(0, (1, 1)),
                 color="black")
    axes[1].bar(centers * 100, np.array(acc_bin) * 100, width=10,
                color="tab:red", edgecolor="black", alpha=0.8)
    axes[1].set(xlim=(0, 100), ylim=(0, 100), xlabel="Confidence (%)",
                ylabel="Accuracy (%)")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def test_prediction_time(model, input_size=(1, 32, 32, 3), n: int = 100,
                         n_ff: int = 1,
                         generator: Optional[torch.Generator] = None,
                         chunk: int = 10) -> AverageMeter:
    """≙ `tests.test_prediction_time` (`tests.py:206-223`): seconds per
    mean-of-softmax prediction of a uniform NHWC input of `input_size`.
    One warm-up call first; then `chunk` predictions per synchronize, each
    on its own input, staged on the device before the chunk's clock
    starts; CUDA events on a GPU, the host clock on the CPU (as
    `zoo.checkpoint.measure_executive_time`). The meter gets each chunk's
    mean once per prediction, so its std is across chunks. Prints "Time:
    avg±std ms" and returns the meter (seconds)."""
    dev = _device_of(model)
    generator = (torch.Generator(dev).manual_seed(0) if generator is None
                 else generator)
    predict = make_predict_fn(model, n_ff)
    meter = AverageMeter("predict_times", "%.3f")
    cuda = dev.type == "cuda"

    def draw():
        return torch.rand(input_size, generator=generator,
                          device=generator.device).to(dev)

    predict(draw(), generator)
    for base in range(0, n, chunk):
        m = min(chunk, n - base)
        xs = [draw() for _ in range(m)]
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for x in xs:
                predict(x, generator)
            end.record()
            end.synchronize()
            per = start.elapsed_time(end) / 1e3 / m
        else:
            t0 = time.perf_counter()
            for x in xs:
                predict(x, generator)
            per = (time.perf_counter() - t0) / m
        for _ in range(m):
            meter.update(per)
    print("Time: %.3f±%.3f ms" % (meter.avg * 1e3, meter.std * 1e3))
    return meter


def save_lists(metrics_dir: str, metrics_list):
    """≙ `tests.save_lists` (`tests.py:226-230`): raw csv rows."""
    import csv

    with open(metrics_dir, "w", newline="") as csvfile:
        writer = csv.writer(csvfile)
        for metrics in metrics_list:
            writer.writerow(metrics)


def save_metrics(metrics_dir: str, metrics_list):
    """≙ `tests.save_metrics` (`tests.py:233-258`): each row is [*keys,
    <metric tuple of test()>], flattened to [*keys, nll, *cutoffs, *accs,
    *uncs, *ious, *freqs, top5, brier, ece, ecse] (the cms and the bins
    are dropped, as the reference drops them)."""
    metrics_acc = []
    for metrics in metrics_list:
        (*keys, nll_value, cutoffs, _cms, accs, uncs, iou_vals, freqs,
         topk_value, brier_value, _count_bin, _acc_bin, _conf_bin,
         ece_value, ecse_value) = metrics
        metrics_acc.append([
            *keys, nll_value, *cutoffs, *accs, *uncs, *iou_vals, *freqs,
            topk_value, brier_value, ece_value, ecse_value,
        ])
    save_lists(metrics_dir, metrics_acc)


def test_perturbation(model, sequences: Iterable[np.ndarray], n_ff: int = 1,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[float, float]:
    """≙ `tests.test_perturbation` (`tests.py:177-207`): mean prediction
    consistency and cross-entropy consistency (CEC) over CIFAR-10-P
    perturbation sequences [B, T, H, W, C]."""
    generator = (torch.Generator().manual_seed(0) if generator is None
                 else generator)
    predict = make_predict_fn(model, n_ff)
    cons_meter = AverageMeter("cons")
    cec_meter = AverageMeter("cec")
    for xs in sequences:
        b, t = xs.shape[0], xs.shape[1]
        flat = xs.reshape((-1,) + xs.shape[2:])
        p = _host(predict(flat, generator)).reshape(b, t, -1)
        idx = np.argmax(p, axis=-1)
        cons = np.mean((idx[:, 1:] == idx[:, :-1]).astype(np.float32),
                       axis=-1)
        cons_meter.update(cons)
        cec = -np.mean(p[:, 1:] * np.log(p[:, :-1] + 0.0), axis=-1)
        cec_meter.update(cec)
    return cons_meter.avg, cec_meter.avg
