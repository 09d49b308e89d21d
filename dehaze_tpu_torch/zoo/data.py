"""Classification datasets and batch transforms of the zoo (counterpart of
`dehaze_tpu/zoo/data.py`, ≙ the reference's `ops/datasets.py`,
`ops/cifarc.py`, `ops/cifarp.py` and the timm Mixup the trainer uses).

The loaders read the standard on-disk formats (CIFAR python pickles, the
robustness benchmarks' `.npy` files, ImageFolder directories) and never
download; `synthetic_dataset` is the deterministic stand-in with the same
shapes. They return the JAX package's NHWC float32 numpy arrays, bit for
bit; the zoo's models take NCHW, so the harness permutes a batch where it
reaches the model, on its device.

Image folders are decoded by `data.images.decode_img` (PNG, BMP and JPEG;
the JAX package's cv2 also reads `.ppm` and `.webp`, which raise here) and
resized by `resize_linear_u8`, this module's copy of cv2's 8-bit
INTER_LINEAR: the GPU host has no cv2.

The training transforms take an explicit `torch.Generator`. Each is a draw
(`augment_draw`, `mixup_draw`: the random numbers) and an apply
(`augment_apply`, `mixup_apply`: the arithmetic on given numbers), so the
arithmetic can be held to the JAX package's given the numbers its key
splits drew.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dehaze_tpu_torch.data.images import load_img

CIFAR10_MEAN, CIFAR10_STD = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
CIFAR100_MEAN, CIFAR100_STD = (0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def get_corruptions(extra: bool = False):
    """`ops/datasets.py:164-176`."""
    base = [
        "gaussian_noise", "shot_noise", "impulse_noise",
        "defocus_blur", "motion_blur", "zoom_blur", "glass_blur",
        "snow", "frost", "fog",
        "brightness", "contrast", "elastic_transform", "pixelate",
        "jpeg_compression",
    ]
    etc = ["speckle_noise", "gaussian_blur", "spatter", "saturate"]
    return base + etc if extra else base


def get_perturbations():
    """`ops/datasets.py:234-240`."""
    return ["gaussian_noise", "shot_noise", "motion_blur", "zoom_blur",
            "spatter", "brightness", "translate", "rotate", "tilt", "scale"]


def _normalize(x: np.ndarray, mean, std) -> np.ndarray:
    return ((x - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32)).astype(np.float32)


def _load_cifar_pickles(root: str, name: str):
    """Read the standard CIFAR python pickle batches (NHWC float [0,1])."""
    if name == "cifar10":
        base = os.path.join(root, "cifar-10-batches-py")
        train_files = [f"data_batch_{i}" for i in range(1, 6)]
        test_files, label_key = ["test_batch"], b"labels"
    else:
        base = os.path.join(root, "cifar-100-python")
        train_files, test_files, label_key = ["train"], ["test"], b"fine_labels"
    if not os.path.isdir(base):
        raise FileNotFoundError(
            f"{base} not found: the loaders never download; place the "
            "standard CIFAR python archives there, or use "
            "dataset='synthetic'")

    def read(files):
        xs, ys = [], []
        for f in files:
            with open(os.path.join(base, f), "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32))
            ys.extend(d[label_key])
        x = np.concatenate(xs).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        return x, np.asarray(ys, np.int32)

    return read(train_files), read(test_files)


def get_dataset(name: str, root: str = "./data", n_synth: int = 512,
                num_classes: Optional[int] = None, seed: int = 0,
                synth_size: Optional[int] = None):
    """≙ `ops/datasets.get_dataset`: ((x_train, y_train), (x_test, y_test),
    num_classes, (mean, std)); images NHWC float32, normalized.
    `synth_size` sets the synthetic images' side (default 32)."""
    if name in ("cifar", "cifar10", "cifar-10"):
        (xtr, ytr), (xte, yte) = _load_cifar_pickles(root, "cifar10")
        mean, std = CIFAR10_MEAN, CIFAR10_STD
        nc = 10
    elif name in ("cifar100", "cifar-100"):
        (xtr, ytr), (xte, yte) = _load_cifar_pickles(root, "cifar100")
        mean, std = CIFAR100_MEAN, CIFAR100_STD
        nc = 100
    elif name == "synthetic":
        nc = num_classes or 10
        (xtr, ytr), (xte, yte) = synthetic_dataset(n_synth, nc, seed=seed,
                                                   size=synth_size or 32)
        mean, std = CIFAR10_MEAN, CIFAR10_STD
    else:
        raise NotImplementedError(name)
    return ((_normalize(xtr, mean, std), ytr),
            (_normalize(xte, mean, std), yte), nc, (mean, std))


def synthetic_dataset(n: int, num_classes: int, seed: int = 0,
                      size: int = 32):
    """Deterministic separable classes: class-coloured blobs + noise."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, num_classes, size=2 * n).astype(np.int32)
    base = rng.random((num_classes, 1, 1, 3)).astype(np.float32)
    xs = base[ys] + 0.25 * rng.standard_normal(
        (2 * n, size, size, 3)).astype(np.float32)
    xs = np.clip(xs, 0.0, 1.0)
    return (xs[:n], ys[:n]), (xs[n:], ys[n:])


def load_cifar_c(root: str, ctype: str, intensity: int, name: str = "cifar10"):
    """≙ `ops/cifarc.py`: `<root>/CIFAR-10-C/<ctype>.npy` + labels.npy,
    intensity 1..5 a slice of 10000 rows (`cifarc.py:69-71`); normalized."""
    if ctype not in get_corruptions(extra=True):
        raise ValueError(f"unknown corruption {ctype!r}; one of "
                         f"{get_corruptions(extra=True)}")
    folder = "CIFAR-10-C" if name == "cifar10" else "CIFAR-100-C"
    mean, std = ((CIFAR10_MEAN, CIFAR10_STD) if name == "cifar10"
                 else (CIFAR100_MEAN, CIFAR100_STD))
    data = np.load(os.path.join(root, folder, f"{ctype}.npy"))
    labels = np.load(os.path.join(root, folder, "labels.npy"))
    sl = slice(10000 * (intensity - 1), 10000 * intensity)
    x = data[sl].astype(np.float32) / 255.0
    return _normalize(x, mean, std), labels[sl].astype(np.int32)


def load_cifar_p(root: str, ptype: str, base_folder: str = "cifar-10-p"):
    """≙ `ops/cifarp.py`: perturbation sequences [N, T, 32, 32, 3], /255 and
    the CIFAR-10 normalization; no labels (consistency and CEC need none)."""
    if ptype not in get_perturbations():
        raise ValueError(f"unknown perturbation {ptype!r}")
    data = np.load(os.path.join(root, base_folder, f"{ptype}.npy"))
    x = data.astype(np.float32) / 255.0
    return _normalize(x, CIFAR10_MEAN, CIFAR10_STD)


def list_image_folder(path: str):
    """torchvision ImageFolder semantics: classes = sorted subdirectory
    names, targets by class index, files sorted within a class."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp")
    classes = sorted(d for d in os.listdir(path)
                     if os.path.isdir(os.path.join(path, d)))
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {path}")
    samples = []
    for ci, c in enumerate(classes):
        cdir = os.path.join(path, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith(exts):
                samples.append((os.path.join(cdir, f), ci))
    return classes, samples


_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE (11 fractional bits)


def _linear_taps(src: int, dst: int, clamp: bool):
    """cv2's INTER_LINEAR taps along one axis: source indices of the two
    taps and their 11-bit weights. Centres (d + 0.5)·src/dst − 0.5 in
    float32, floored; the horizontal pass clamps the position at the
    edges, the vertical one clamps only the row indices."""
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0.0
        s[lo] = 0
        s[hi] = src - 1
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(
        np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=INTER_LINEAR) for an
    [H, W, C] uint8 image: half-pixel centres, no antialias, cv2's fixed
    point (11-bit weights, the horizontal pass kept as integers, the
    vertical pass rounded as its SIMD path does, ((a >> 4)·w >> 16 summed,
    + 2) >> 2), and its exact 2× shrink, which cv2 takes as INTER_AREA."""
    h0, w0 = img.shape[:2]
    if (w0, h0) == (width, height):
        return img.copy()
    x = img.astype(np.int64)
    if (w0, h0) == (2 * width, 2 * height):
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    xs0, xs1, a0, a1 = _linear_taps(w0, width, clamp=True)
    ys0, ys1, b0, b1 = _linear_taps(h0, height, clamp=False)
    rows = x[:, xs0] * a0[None, :, None] + x[:, xs1] * a1[None, :, None]
    out = ((((rows[ys0] >> 4) * b0[:, None, None]) >> 16)
           + (((rows[ys1] >> 4) * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def eval_crop_u8(img: np.ndarray, size: int) -> np.ndarray:
    """The eval transform on one decoded uint8 image
    (`ops/datasets.py:128-130` transforms_imagenet_eval): resize the
    shorter side to round(size / 0.875), centre-crop `size`."""
    h, w = img.shape[:2]
    short = int(round(size / 0.875))
    scale = short / min(h, w)
    img = resize_linear_u8(img, max(short, int(round(w * scale))),
                           max(short, int(round(h * scale))))
    h, w = img.shape[:2]
    y0, x0 = (h - size) // 2, (w - size) // 2
    return img[y0:y0 + size, x0:x0 + size]


def image_folder_batches(path: str, batch_size: int, *, size: int = 224,
                         mean=IMAGENET_MEAN, std=IMAGENET_STD,
                         indices=None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream an ImageFolder directory as normalized NHWC float32 batches
    under the eval transform (`eval_crop_u8`), one batch in memory."""
    _, samples = list_image_folder(path)
    if indices is not None:
        samples = [samples[i] for i in indices]
    xs, ys = [], []
    for fp, ci in samples:
        img = eval_crop_u8(load_img(fp, u8=True), size)
        xs.append(img.astype(np.float32) / 255.0)
        ys.append(ci)
        if len(xs) == batch_size:
            yield _normalize(np.stack(xs), mean, std), np.asarray(ys, np.int32)
            xs, ys = [], []
    if xs:
        yield _normalize(np.stack(xs), mean, std), np.asarray(ys, np.int32)


def imagenet_batches(batch_size: int, *, root: str = "./data",
                     base_folder: str = "imagenet", split: str = "val",
                     size: int = 224):
    """≙ `ops/datasets.get_imagenet`, eval side (`datasets.py:110-139`):
    `<root>/imagenet/{train,val}` as an ImageFolder, ImageNet normalize."""
    path = os.path.join(root, base_folder, split)
    return image_folder_batches(path, batch_size, size=size)


def imagenet_c_batches(ctype: str, intensity: int, batch_size: int, *,
                       root: str = "./data", base_folder: str = "imagenetc",
                       size: int = 224):
    """≙ `ops/imagenetc.ImageNetC` (`imagenetc.py:14-46`):
    `<root>/imagenetc/<ctype>/<intensity>` as an ImageFolder."""
    if ctype not in get_corruptions(extra=True):
        raise ValueError(f"unknown corruption {ctype!r}; one of "
                         f"{get_corruptions(extra=True)}")
    path = os.path.join(root, base_folder, ctype, str(intensity))
    return image_folder_batches(path, batch_size, size=size)


def subsample(targets, ratio: float, random: bool = True, seed: int = 0):
    """≙ `ops/datasets.subsample` (`datasets.py:141-162`): per class
    `int(size * ratio)` indices, a random split or the head; takes the
    label array."""
    idxs_sorted = {}
    for idx, target in enumerate(np.asarray(targets)):
        idxs_sorted.setdefault(int(target), []).append(idx)
    rng = np.random.default_rng(seed)
    out = []
    for c, idxs in idxs_sorted.items():
        n = int(len(idxs) * ratio)
        if random:
            out.extend(rng.permutation(idxs)[:n].tolist())
        else:
            out.extend(idxs[:n])
    return out


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, *,
            shuffle: bool = False, seed: int = 0,
            drop_remainder: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = n - (n % batch_size) if drop_remainder else n
    for i in range(0, stop, batch_size):
        sel = idx[i:i + batch_size]
        yield x[sel], y[sel]


# --------------------------------------------------------------------------
# batch transforms on NHWC tensors, on their device
# --------------------------------------------------------------------------

def _uniform(generator: torch.Generator, shape=()) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


def augment_draw(generator: torch.Generator, batch: int, padding: int = 4,
                 hflip: float = 0.5):
    """The random numbers of `augment_batch`: crop offsets [B, 2] (row,
    column) in [0, 2·padding] and flips [B] (bool)."""
    offs = torch.randint(0, 2 * padding + 1, (batch, 2), generator=generator,
                         device=generator.device)
    flip = _uniform(generator, (batch,)) < hflip
    return offs, flip


def augment_apply(x: torch.Tensor, offs: torch.Tensor, flip: torch.Tensor,
                  padding: int = 4) -> torch.Tensor:
    """Zero-pad by `padding`, crop each image at its offset, flip the
    images whose flag is set, mirrored along the width."""
    b, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    offs = offs.to(x.device)
    rows = offs[:, 0, None] + torch.arange(h, device=x.device)
    cols = offs[:, 1, None] + torch.arange(w, device=x.device)
    out = xp[torch.arange(b, device=x.device)[:, None, None],
             rows[:, :, None], cols[:, None, :]]
    return torch.where(flip.to(x.device)[:, None, None, None],
                       out.flip(2), out)


def augment_batch(generator: torch.Generator, x: torch.Tensor,
                  padding: int = 4, hflip: float = 0.5) -> torch.Tensor:
    """Pad-`padding` random crop + horizontal flip, the cifar recipe
    (`configs/cifar10_vit.yaml` padding: 4; `ops/datasets.py:50-53`), on a
    whole NHWC batch."""
    offs, flip = augment_draw(generator, x.shape[0], padding, hflip)
    return augment_apply(x, offs, flip, padding)


def one_hot_smooth(y: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    return F.one_hot(y.long(), num_classes).float() * (on - off) + off


def _gamma(generator: torch.Generator, alpha: float) -> float:
    """One Gamma(alpha, 1) draw (Marsaglia and Tsang; alpha < 1 through
    Gamma(alpha + 1)·U^(1/alpha)) from the generator's normals and
    uniforms."""
    boost = 1.0
    if alpha < 1.0:
        boost = float(_uniform(generator)) ** (1.0 / alpha)
        alpha += 1.0
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        z = float(torch.randn((), generator=generator,
                              device=generator.device))
        v = (1.0 + c * z) ** 3
        if v <= 0.0:
            continue
        u = float(_uniform(generator))
        if math.log(u) < 0.5 * z * z + d - d * v + d * math.log(v):
            return d * v * boost


def _beta(generator: torch.Generator, a: float, b: float) -> float:
    x, y = _gamma(generator, a), _gamma(generator, b)
    return x / (x + y)


def mixup_draw(generator: torch.Generator, h: int, w: int, *,
               mixup_alpha: float = 1.0, cutmix_alpha: float = 0.8,
               prob: float = 1.0, switch_prob: float = 0.5) -> dict:
    """The random numbers of `mixup_cutmix`, one draw per batch: `use`,
    `use_cutmix`, `lam0` (Beta(mixup_alpha) or, for cutmix,
    Beta(cutmix_alpha)) and the box centre `cy`, `cx`, both from one
    uniform, as the JAX package takes both from one key."""
    use = bool(_uniform(generator) < prob)
    use_cutmix = bool(_uniform(generator) < switch_prob)
    alpha = cutmix_alpha if use_cutmix else mixup_alpha
    lam0 = _beta(generator, alpha, alpha)
    u = float(_uniform(generator))
    return {"use": use, "use_cutmix": use_cutmix, "lam0": lam0,
            "cy": int(u * h), "cx": int(u * w)}


def mixup_apply(x: torch.Tensor, y: torch.Tensor, num_classes: int,
                draw: dict, smoothing: float = 0.0):
    """timm `Mixup` on an NHWC batch given `mixup_draw`'s numbers: the pair
    is the batch flipped; cutmix recomputes λ from the clipped box's area;
    without `use` the batch and its (smoothed) one-hot targets pass
    through. Returns (x_mixed, soft_targets)."""
    b, h, w, _ = x.shape
    t = one_hot_smooth(y, num_classes, smoothing).to(x.device)
    if not draw["use"]:
        return x, t
    t_flip, x_flip = t.flip(0), x.flip(0)
    lam0 = np.float32(draw["lam0"])
    if draw["use_cutmix"]:
        cut = np.sqrt(np.float32(1.0) - lam0)
        ch, cw = int(cut * np.float32(h)), int(cut * np.float32(w))
        cy, cx = draw["cy"], draw["cx"]
        y0, y1 = min(max(cy - ch // 2, 0), h), min(max(cy + ch // 2, 0), h)
        x0, x1 = min(max(cx - cw // 2, 0), w), min(max(cx + cw // 2, 0), w)
        box = torch.zeros(1, h, w, 1, dtype=torch.bool, device=x.device)
        box[:, y0:y1, x0:x1] = True
        area = np.float32((y1 - y0) * (x1 - x0)) / np.float32(h * w)
        lam = float(np.float32(1.0) - area)
        x_mix = torch.where(box, x_flip, x)
    else:
        lam = float(lam0)
        x_mix = lam * x + (1 - lam) * x_flip
    return x_mix, lam * t + (1 - lam) * t_flip


def mixup_cutmix(generator: torch.Generator, x: torch.Tensor,
                 y: torch.Tensor, num_classes: int, *,
                 mixup_alpha: float = 1.0, cutmix_alpha: float = 0.8,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 smoothing: float = 0.0):
    """timm `Mixup(mixup_alpha, cutmix_alpha, prob)` as the config uses it
    (`configs/cifar10_vit.yaml:26-30`, `ops/trains.py:70-74`): one draw
    per batch; returns (x_mixed, soft_targets)."""
    draw = mixup_draw(generator, x.shape[1], x.shape[2],
                      mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                      prob=prob, switch_prob=switch_prob)
    return mixup_apply(x, y, num_classes, draw, smoothing)
