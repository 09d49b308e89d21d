"""The zoo's evaluation harness on the port against the JAX package, on the
CPU: `zoo.data` (loaders, image folders, batch transforms), the metric
primitives and `evaluate.test`/`test_perturbation`, `ensemble`, the
attacks and `fourier`.

Two registry models at 32², 10 classes: AlexNet (the conv net) and ViT-Ti
with 8×8 patches; each a JAX init (its weights nudged by seeded noise so
that the logits spread), carried to the port by
`zoo_state_dict_from_jax_variables`. Inputs are seeded numpy, NHWC for
JAX and NCHW where the port's attacks take them. f32 tolerances: 2e-4
(NLL, Brier, the ECEs, latents and their Fourier profiles), 1e-5 for
`freq_mask`, 1e-12 relative for the metric primitives on the same p.
"""

import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dehaze_tpu.zoo import adversarial as JAD
from dehaze_tpu.zoo import data as JD
from dehaze_tpu.zoo import ensemble as JEN
from dehaze_tpu.zoo import evaluate as JE
from dehaze_tpu.zoo import fourier as JF
from dehaze_tpu.zoo import get_model as jax_get_model
from dehaze_tpu.zoo.train import soft_ce as jax_soft_ce
from dehaze_tpu_torch.utils.convert import zoo_state_dict_from_jax_variables
from dehaze_tpu_torch.zoo import adversarial as TAD
from dehaze_tpu_torch.zoo import data as TD
from dehaze_tpu_torch.zoo import ensemble as TEN
from dehaze_tpu_torch.zoo import evaluate as TE
from dehaze_tpu_torch.zoo import fourier as TF
from dehaze_tpu_torch.zoo import get_model
from dehaze_tpu_torch.zoo import layers as ZL
from dehaze_tpu_torch.zoo.train import soft_ce

TOL = 2e-4
MODELS = {"alexnet": {}, "vit_ti": {"image_size": 32, "patch_size": 8}}
HEAD_GAIN = {"alexnet": 14.0, "vit_ti": 3.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU tensors: with several test
    workers on the host, torch's thread pools stall each other in
    hand-offs (a small op then takes tens of times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nudged(variables, seed, head_gain):
    """The JAX init with seeded noise on every parameter leaf, half the
    leaf's own spread (0.02 on a constant leaf), and the head's kernel
    (the [C, 10] leaf) times `head_gain`: the init's near-uniform
    probabilities would test no confidence cutoff."""
    rng = np.random.default_rng(seed)

    def nudge(a):
        a = np.asarray(a)
        scale = 0.5 * a.std() if a.std() > 0 else 0.02
        a = a + scale * rng.standard_normal(a.shape).astype(np.float32)
        return jnp.asarray(a * head_gain if a.ndim == 2 and a.shape[1] == 10
                           else a)

    return {**variables, "params": jax.tree.map(nudge, variables["params"])}


def _pair(name, seed=1):
    kw = MODELS[name]
    jm = jax_get_model(name, num_classes=10, **kw)
    k = jax.random.PRNGKey(seed)
    init = jax.jit(lambda key: jm.init(
        {"params": key, "dropout": key, "droppath": key},
        jnp.zeros((1, 32, 32, 3)), train=False))
    v = _nudged(init(k), seed, HEAD_GAIN[name])
    tm = get_model(name, num_classes=10, **kw).eval()
    tm.load_state_dict(zoo_state_dict_from_jax_variables(v, tm))
    return jm, v, tm


class _Jitted:
    """A flax module whose `apply` runs as one jitted program per set of
    static keywords (called eagerly, as the JAX package's
    `collect_latents` calls it, each primitive compiles on its own)."""

    def __init__(self, module):
        self.module = module
        self._fns = {}

    def apply(self, variables, x, rngs=None, **static):
        key = repr(sorted(static.items()))
        if key not in self._fns:
            self._fns[key] = jax.jit(lambda vs, a, r: self.module.apply(
                vs, a, rngs=r, **static))
        return self._fns[key](variables, x, rngs)


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in MODELS}


def _images(n, seed=0, side=32):
    return (np.random.default_rng(seed).standard_normal(
        (n, side, side, 3)).astype(np.float32) * 0.5)


def _labels(n, seed=0):
    return np.random.default_rng(seed + 100).integers(0, 10, n).astype(
        np.int32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ----------------------------------------------------------------- loaders

def _cifar_tree(root, rng):
    c10 = root / "cifar-10-batches-py"
    c100 = root / "cifar-100-python"
    c10.mkdir(parents=True)
    c100.mkdir(parents=True)
    for f in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(c10 / f, "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 3).tolist()}, fh)
    for f in ("train", "test"):
        with open(c100 / f, "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072),
                                               dtype=np.uint8),
                         b"fine_labels": rng.integers(0, 100, 4).tolist()},
                        fh)


def _equal_tree(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal_tree(u, v)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_loaders_equal_jax_bit_for_bit(tmp_path):
    """CIFAR-10/100 pickles, CIFAR-10-C (intensity 2 of 10003 rows) and
    CIFAR-10-P `.npy` files, the synthetic set, subsample and batches."""
    rng = np.random.default_rng(0)
    _cifar_tree(tmp_path, rng)
    cdir = tmp_path / "CIFAR-10-C"
    cdir.mkdir()
    np.save(cdir / "fog.npy", rng.integers(0, 256, (10003, 2, 2, 3),
                                           dtype=np.uint8))
    np.save(cdir / "labels.npy", rng.integers(0, 10, 10003))
    pdir = tmp_path / "cifar-10-p"
    pdir.mkdir()
    np.save(pdir / "rotate.npy", rng.integers(0, 256, (2, 3, 32, 32, 3),
                                              dtype=np.uint8))
    root = str(tmp_path)
    assert TD.get_corruptions() == JD.get_corruptions()
    assert TD.get_corruptions(True) == JD.get_corruptions(True)
    assert TD.get_perturbations() == JD.get_perturbations()
    for name in ("cifar10", "cifar100"):
        _equal_tree(TD.get_dataset(name, root), JD.get_dataset(name, root))
    _equal_tree(TD.get_dataset("synthetic", n_synth=7, num_classes=4, seed=3,
                               synth_size=8),
                JD.get_dataset("synthetic", n_synth=7, num_classes=4, seed=3,
                               synth_size=8))
    for intensity in (1, 2):
        _equal_tree(TD.load_cifar_c(root, "fog", intensity),
                    JD.load_cifar_c(root, "fog", intensity))
    assert TD.load_cifar_c(root, "fog", 2)[0].shape == (3, 2, 2, 3)
    _equal_tree(TD.load_cifar_p(root, "rotate"),
                JD.load_cifar_p(root, "rotate"))
    with pytest.raises(ValueError, match="corruption"):
        TD.load_cifar_c(root, "nope", 1)
    with pytest.raises(ValueError, match="perturbation"):
        TD.load_cifar_p(root, "nope")
    with pytest.raises(FileNotFoundError, match="never download"):
        TD.get_dataset("cifar10", str(tmp_path / "empty"))
    y = rng.integers(0, 5, 40)
    for random in (True, False):
        assert TD.subsample(y, 0.3, random, seed=2) == JD.subsample(
            y, 0.3, random, seed=2)
    x = rng.standard_normal((10, 2, 2, 3)).astype(np.float32)
    for kw in ({}, {"shuffle": True, "seed": 4},
               {"drop_remainder": False}):
        _equal_tree(list(TD.batches(x, y[:10], 4, **kw)),
                    list(JD.batches(x, y[:10], 4, **kw)))


def test_resize_matches_cv2_inter_linear():
    """The port's INTER_LINEAR on uint8 against cv2's at shrinks, stretches,
    the exact 2× shrink and the identity: at most 1 level apart."""
    rng = np.random.default_rng(5)
    differing = 0
    for (h, w), (dh, dw) in [((37, 53), (21, 30)), ((20, 31), (46, 37)),
                             ((64, 48), (32, 24)), ((17, 90), (40, 40)),
                             ((33, 33), (33, 33)), ((9, 120), (37, 137))]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        got = TD.resize_linear_u8(img, dw, dh)
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1, ((h, w), (dh, dw))
        differing += int((d > 0).sum())
    print(f"resize: {differing} samples differ from cv2 by 1 level")


def _image_folder(root, rng):
    """Two classes of PNG, JPEG and BMP files of assorted sizes."""
    for ci, cname in enumerate(("cat", "dog")):
        os.makedirs(root / cname)
        for i, (h, w, ext) in enumerate([(40, 56, ".png"), (61, 45, ".jpg"),
                                         (30, 30, ".bmp"), (72, 36, ".png")]):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            img = cv2.GaussianBlur(img, (5, 5), 0)  # JPEG-friendly
            cv2.imwrite(str(root / cname / f"{i}{ext}"), img)
        (root / cname / "notes.txt").write_text("not an image")


def _levels(x, mean, std):
    return np.rint((x * np.asarray(std, np.float32)
                    + np.asarray(mean, np.float32)) * 255.0).astype(int)


def test_image_folder_batches_against_cv2(tmp_path):
    """The port's decode + resize + centre crop against the JAX package's
    cv2 path: labels equal, pixels within 1 uint8 level before the
    normalization (the count of differing samples printed)."""
    rng = np.random.default_rng(6)
    folder = tmp_path / "imagenet" / "val"
    _image_folder(folder, rng)
    _image_folder(tmp_path / "imagenetc" / "fog" / "3", rng)
    assert TD.list_image_folder(str(folder)) == JD._list_image_folder(
        str(folder))
    runs = [(TD.image_folder_batches(str(folder), 3, size=24),
             JD.image_folder_batches(str(folder), 3, size=24)),
            (TD.imagenet_batches(5, root=str(tmp_path), size=16),
             JD.imagenet_batches(5, root=str(tmp_path), size=16)),
            (TD.imagenet_c_batches("fog", 3, 8, root=str(tmp_path), size=20),
             JD.imagenet_c_batches("fog", 3, 8, root=str(tmp_path),
                                   size=20))]
    differing = total = 0
    for got_it, want_it in runs:
        got, want = list(got_it), list(want_it)
        assert [g[0].shape for g in got] == [w[0].shape for w in want]
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gy, wy)
            assert gx.dtype == np.float32
            d = np.abs(_levels(gx, JD.IMAGENET_MEAN, JD.IMAGENET_STD)
                       - _levels(wx, JD.IMAGENET_MEAN, JD.IMAGENET_STD))
            assert d.max() <= 1
            differing += int((d > 0).sum())
            total += d.size
    print(f"image folders: {differing} of {total} samples 1 level off cv2")
    with pytest.raises(ValueError, match="corruption"):
        next(TD.imagenet_c_batches("nope", 1, 2, root=str(tmp_path)))


# ---------------------------------------------------------- transforms

def test_augment_batch_equals_jax_given_its_draws():
    x = _images(5, seed=7, side=8)

    @jax.jit
    def jax_draws(rng):  # the numbers of JAX's key splits
        kc, kf = jax.random.split(rng)
        return (jax.random.randint(kc, (5, 2), 0, 9),
                jax.random.bernoulli(kf, 0.5, (5, 1, 1, 1)))

    jax_augment = jax.jit(JD.augment_batch)
    for seed in range(3):
        rng = jax.random.PRNGKey(seed)
        offs, flip = (np.asarray(a) for a in jax_draws(rng))
        want = np.asarray(jax_augment(rng, jnp.asarray(x)))
        got = TD.augment_apply(torch.from_numpy(x),
                               torch.from_numpy(offs.copy()),
                               torch.from_numpy(flip.reshape(5).copy()))
        np.testing.assert_array_equal(got.numpy(), want)
    # the draw: offsets in [0, 2·padding], one generator, one result
    g = torch.Generator().manual_seed(3)
    offs, flip = TD.augment_draw(g, 64, padding=2)
    assert offs.shape == (64, 2) and int(offs.min()) >= 0
    assert int(offs.max()) <= 4 and flip.dtype == torch.bool
    a = TD.augment_batch(torch.Generator().manual_seed(9),
                         torch.from_numpy(x))
    b = TD.augment_batch(torch.Generator().manual_seed(9),
                         torch.from_numpy(x))
    assert torch.equal(a, b) and a.shape == x.shape


def test_mixup_cutmix_equals_jax_given_its_draws():
    """Both branches and the pass-through, on a non-square batch: the box
    clipped, λ from the box's area, the pair the flipped batch, cy and cx
    from one key."""
    x = _images(4, seed=8, side=12)[:, :, :10]
    y = np.array([1, 7, 3, 7], np.int32)

    @jax.jit
    def jax_draws(rng):  # the numbers of JAX's key splits
        k1, k2, k3, k4 = jax.random.split(rng, 4)
        return (jax.random.bernoulli(k1, 0.7), jax.random.bernoulli(k2, 0.5),
                jax.random.beta(k3, 0.8, 0.8), jax.random.beta(k3, 1.0, 1.0),
                jax.random.randint(k4, (), 0, 12),
                jax.random.randint(k4, (), 0, 10))

    jax_mix = jax.jit(lambda rng: JD.mixup_cutmix(
        rng, jnp.asarray(x), jnp.asarray(y), 10, prob=0.7, smoothing=0.1))
    seen = set()
    for seed in range(40):
        rng = jax.random.PRNGKey(seed)
        use, cutmix, lam_cut, lam_mix, cy, cx = jax_draws(rng)
        use, cutmix = bool(use), bool(cutmix)
        draw = {"use": use, "use_cutmix": cutmix,
                "lam0": float(lam_cut if cutmix else lam_mix),
                "cy": int(cy), "cx": int(cx)}
        wx, wt = jax_mix(rng)
        gx, gt = TD.mixup_apply(torch.from_numpy(x), torch.from_numpy(y), 10,
                                draw, smoothing=0.1)
        # exact but for one f32 rounding at the largest magnitude, where
        # XLA fuses λ·a + (1 − λ)·b
        for g, w, top in ((gx, wx, np.abs(x).max()), (gt, wt, 1.0)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=np.spacing(np.float32(top)))
        if cutmix or not use:  # a select, no arithmetic on the images
            np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        seen.add((use, cutmix and use))
        if len(seen) == 3:
            break
    assert seen == {(True, True), (True, False), (False, False)}
    np.testing.assert_array_equal(
        TD.one_hot_smooth(torch.tensor([0, 9]), 10, 0.2).numpy(),
        np.asarray(JD.one_hot_smooth(jnp.array([0, 9]), 10, 0.2)))
    # the draws: Beta(α, α) has mean 1/2 and variance 1/(4(2α + 1))
    g = torch.Generator().manual_seed(0)
    for alpha in (0.8, 1.0):
        lam = np.array([TD._beta(g, alpha, alpha) for _ in range(2000)])
        assert abs(lam.mean() - 0.5) < 0.02
        assert abs(lam.var() - 1 / (4 * (2 * alpha + 1))) < 0.01
    d = TD.mixup_draw(torch.Generator().manual_seed(1), 12, 10)
    assert set(d) == {"use", "use_cutmix", "lam0", "cy", "cx"}
    assert 0 <= d["cy"] < 12 and 0 <= d["cx"] < 10
    a = TD.mixup_cutmix(torch.Generator().manual_seed(5),
                        torch.from_numpy(x), torch.from_numpy(y), 10)
    b = TD.mixup_cutmix(torch.Generator().manual_seed(5),
                        torch.from_numpy(x), torch.from_numpy(y), 10)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    np.testing.assert_allclose(a[1].sum(-1).numpy(), 1.0, rtol=1e-6)


def test_soft_ce_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    t = rng.dirichlet(np.ones(10), 6).astype(np.float32)
    np.testing.assert_allclose(
        float(soft_ce(torch.from_numpy(logits), torch.from_numpy(t))),
        float(jax_soft_ce(jnp.asarray(logits), jnp.asarray(t))), rtol=1e-6)


# ------------------------------------------------------- metric primitives

def _probs(n=200, c=10, seed=10):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(c, 0.3), n)
    ys = rng.integers(0, c, n)
    # zero probabilities outside the target class; confidence exactly 1
    p[(rng.random((n, c)) < 0.05) & (np.arange(c) != ys[:, None])] = 0.0
    p[:3] = np.eye(c)[ys[:3]]
    return p / p.sum(1, keepdims=True), ys


def test_metric_primitives_equal_jax():
    p, ys = _probs()
    rel = dict(rtol=1e-12, atol=0)
    np.testing.assert_allclose(TE.brier(ys, p), JE.brier(ys, p), **rel)
    np.testing.assert_array_equal(TE.topk(ys, p), JE.topk(ys, p))
    for lo, hi in ((0.0, 1.0), (0.9, 1.0), (0.0, 0.9), (0.3, 0.4)):
        want = JE.cm(ys, p, lo, hi)
        np.testing.assert_array_equal(TE.cm(ys, p, lo, hi), want)
        np.testing.assert_allclose(TE.ious(want), JE.ious(want), **rel)
        assert TE.miou(want) == JE.miou(want)
        assert TE.gacc(want) == JE.gacc(want)
        assert TE.caccs(want) == JE.caccs(want)
    cert, unc = JE.cm(ys, p, 0.5), JE.cm(ys, p, 0.0, 0.5)
    assert TE.unconfidence(cert, unc) == JE.unconfidence(cert, unc)
    assert TE.frequency(cert, unc) == JE.frequency(cert, unc)
    empty = np.zeros((10, 10))
    assert TE.miou(empty) == JE.miou(empty) == 0.0
    assert TE.gacc(empty) == 0.0 and TE.caccs(empty) == JE.caccs(empty)
    count, acc, conf = ([0, 4, 9, 1], [0.0, 0.5, 0.7, 1.0],
                        [0.05, 0.45, 0.8, 0.95])
    assert TE.ece(count, acc, conf) == JE.ece(count, acc, conf)
    assert TE.ecse(count, acc, conf) == JE.ecse(count, acc, conf)
    soft = np.random.default_rng(11).dirichlet(np.ones(10), len(ys))
    for ys_soft, smoothing in ((None, 0.0), (None, 0.1), (soft, 0.0)):
        want = JE._nll(p, ys, ys_soft, smoothing)
        got = TE._nll(p, ys, ys_soft, smoothing)
        # finite with one-hot targets: zeros outside the target class
        # weigh nothing; a smoothed or soft target weighs them: +inf
        assert np.isfinite(want) == (ys_soft is None and smoothing == 0.0)
        np.testing.assert_allclose(got, want, **rel)
    # a zero probability in the target class: +inf, as torch's CE
    p0 = p.copy()
    p0[0] = np.eye(10)[(ys[0] + 1) % 10]
    assert TE._nll(p0, ys, None, 0.0) == JE._nll(p0, ys, None, 0.0) == np.inf


# ------------------------------------------------------ test() and friends

def _near_ties(p, edges):
    """Samples whose top-2 probabilities or whose confidence and a cm edge
    lie within 1e-5: their cm cell may move between two f32 runs."""
    top = np.sort(p, axis=1)
    conf = top[:, -1]
    close = (top[:, -1] - top[:, -2] < 1e-5)
    for e in edges:
        close |= np.abs(conf - e) < 1e-5
    return int(close.sum())


def _assert_metrics_close(got, want, p, cutoffs, bins):
    assert got[1] == want[1]
    for i in (0, 8, 12, 13):  # NLL, Brier, ECE, ECE±
        np.testing.assert_allclose(got[i], want[i], rtol=TOL, atol=TOL)
    ties = _near_ties(p, list(cutoffs) + list(bins))
    moved = sum(int(np.abs(np.asarray(g) - np.asarray(w)).sum())
                for gg, ww in zip(got[2], want[2]) for g, w in zip(gg, ww))
    moved += int(np.abs(np.asarray(got[9]) - np.asarray(want[9])).sum())
    assert moved <= 4 * ties, (moved, ties)
    if not ties:
        for i in (3, 4, 5, 6, 10):
            np.testing.assert_allclose(got[i], want[i], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got[7], want[7], atol=ties / len(p) + 1e-12)
    np.testing.assert_allclose(got[11], want[11], rtol=TOL, atol=TOL)


def test_calibration_test_and_perturbation_match_jax(pairs, tmp_path, capsys):
    """`test()` (with a label-smoothing transform too) and
    `test_perturbation` on the same weights and batches; repr_metrics on
    the same tuple; save_metrics rows parsed and compared."""
    jm, v, tm = pairs["alexnet"]
    x, y = _images(32, seed=12), _labels(32, seed=12)
    bins = np.linspace(0.0, 1.0, 11)
    want = JE.test(jm, v, JD.batches(x, y, 16))
    got = TE.test(tm, TD.batches(x, y, 16))
    p = np.concatenate([np.asarray(JE.make_predict_fn(jm, v)(
        jnp.asarray(x[i:i + 16]), jax.random.PRNGKey(0)))
        for i in (0, 16)])
    assert p.max() > 0.5, "the nudged weights should give confident rows"
    _assert_metrics_close(got, want, p, (0.0, 0.9), bins)
    assert TE.repr_metrics(want) == JE.repr_metrics(want)
    tiny = (5e-3,) + tuple(want[1:])
    assert TE.repr_metrics(tiny) == JE.repr_metrics(tiny)
    assert "NLL: 5.0000e-03" in TE.repr_metrics(tiny)

    smooth_j = JE.test(jm, v, JD.batches(x, y, 16), transform=lambda k, a, b: (
        a, JD.one_hot_smooth(b, 10, 0.1)))
    smooth_t = TE.test(tm, TD.batches(x, y, 16), transform=lambda g, a, b: (
        a, TD.one_hot_smooth(b, 10, 0.1)))
    _assert_metrics_close(smooth_t, smooth_j, p, (0.0, 0.9), bins)

    paths = [str(tmp_path / f"{s}.csv") for s in ("jax", "port")]
    JE.save_metrics(paths[0], [["fog", 3, *want]])
    TE.save_metrics(paths[1], [["fog", 3, *got]])
    rows = [open(f).read().strip().split(",") for f in paths]
    assert len(rows[0]) == len(rows[1]) == 2 + 1 + 2 + 4 * 2 + 4
    assert rows[0][:2] == rows[1][:2] == ["fog", "3"]
    np.testing.assert_allclose(np.array(rows[1][2:], float),
                               np.array(rows[0][2:], float),
                               rtol=TOL, atol=TOL)

    seqs = _images(16, seed=13).reshape(2, 8, 32, 32, 3)
    cons_j, cec_j = JE.test_perturbation(jm, v, [seqs])
    cons_t, cec_t = TE.test_perturbation(tm, [seqs])
    assert cons_t == cons_j
    np.testing.assert_allclose(cec_t, cec_j, rtol=TOL, atol=TOL)

    TE.test(tm, TD.batches(x, y, 16), verbose=True, period=1)
    assert capsys.readouterr().out.startswith("1 Steps, NLL: ")
    meter = TE.test_prediction_time(tm, input_size=(2, 32, 32, 3), n=3,
                                    chunk=2)
    assert meter.count == 3 and meter.avg > 0.0
    assert capsys.readouterr().out.startswith("Time: ")
    fig = tmp_path / "rel.png"
    TE.test(tm, TD.batches(x, y, 16), fig_path=str(fig))
    assert fig.stat().st_size > 0


class _MCStub(torch.nn.Module):
    """A linear classifier behind MC dropout (not a registry model)."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(12, 10)

    def forward(self, x, generators=None, taps=None):
        x = ZL.mc_dropout(x.flatten(1), 0.5, generators)
        return self.fc(x)


def test_predict_fn_mean_of_n_ff_softmaxes_and_device():
    """`make_predict_fn`: NHWC in, the mean of n_ff softmaxes whose masks
    come one after another from the generator; the same seed gives the
    same probabilities; a bf16 model keeps bf16 probabilities."""
    torch.manual_seed(0)
    model = _MCStub()
    x = _images(3, seed=14, side=2)
    predict = TE.make_predict_fn(model, n_ff=3)
    got = predict(x, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    xt = _nchw(x)
    want = torch.stack([torch.softmax(model(xt, {"dropout": g}), -1)
                        for _ in range(3)]).mean(0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(got, predict(x, torch.Generator().manual_seed(4)))
    assert not torch.equal(got, predict(x, torch.Generator().manual_seed(5)))
    with pytest.raises(ValueError, match="dropout"):
        predict(x)
    bf = get_model("alexnet", num_classes=10, dtype=torch.bfloat16)
    assert TE.make_predict_fn(bf)(_images(1)).dtype == torch.bfloat16


# ------------------------------------------------------------- ensembles

def test_combine_logits_and_ensembles_match_jax(pairs):
    rng = np.random.default_rng(15)
    stacked = rng.standard_normal((3, 4, 10)).astype(np.float32) * 2
    np.testing.assert_allclose(
        TEN.combine_logits(torch.from_numpy(stacked)).numpy(),
        np.asarray(JEN.combine_logits(jnp.asarray(stacked))),
        rtol=1e-6, atol=1e-6)
    x = _images(2, seed=16)
    (ja, va, ta), (_, _, tv) = pairs["alexnet"], pairs["vit_ti"]
    ja2, va2, ta2 = _pair("alexnet", seed=2)
    # the weights are jit arguments, not constants baked into the program
    het_j = jax.jit(lambda vs, a: JEN.Ensemble(
        [(ja, vs[0]), (ja2, vs[1])], train=False)(a))
    het_t = TEN.Ensemble([ta, ta2])
    assert het_t.name == JEN.Ensemble([(ja, va)]).name == "alexnet_ensemble"
    assert het_t.num_members == 2
    with torch.no_grad():
        np.testing.assert_allclose(het_t(_nchw(x)).numpy(),
                                   np.asarray(het_j((va, va2), x)),
                                   rtol=TOL, atol=TOL)
        # members of two architectures: the rule on their own logits
        mixed = TEN.Ensemble([ta, tv])
        torch.testing.assert_close(mixed(_nchw(x)), TEN.combine_logits(
            torch.stack([ta(_nchw(x)), tv(_nchw(x))])), rtol=0, atol=0)
    stacked = JEN.stack_variables([va, va2])
    st_j = jax.jit(lambda sv, a: JEN.Ensemble.stacked(ja, sv,
                                                      train=False)(a))
    st_t = TEN.Ensemble.stacked(
        ta, TEN.stack_state_dicts([ta.state_dict(), ta2.state_dict()]))
    assert st_t.num_members == JEN.Ensemble.stacked(
        ja, stacked).num_members == 2
    assert st_t.name == "alexnet_ensemble"
    with torch.no_grad():
        got = st_t(_nchw(x))
        loop = TEN.Ensemble([ta, ta2])(_nchw(x))
    torch.testing.assert_close(got, loop, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(st_j(stacked, x)),
                               rtol=TOL, atol=TOL)
    assert TEN.Ensemble([ta], name="mine").name == "mine"
    with pytest.raises(ValueError, match="leading axes"):
        TEN.Ensemble.stacked(ta, {"a": torch.zeros(2, 3),
                                  "b": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="differs"):
        TEN.stack_state_dicts([{"a": torch.zeros(1)}, {"b": torch.zeros(1)}])
    with pytest.raises(ValueError, match="at least one"):
        TEN.Ensemble([])


# --------------------------------------------------------------- attacks

def _check_grad(got_nchw, want_nhwc):
    want = np.asarray(want_nhwc).transpose(0, 3, 1, 2)
    got = got_nchw.numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= TOL * scale
    big = np.abs(want) > 1e-4 * scale
    np.testing.assert_array_equal(np.sign(got[big]), np.sign(want[big]))
    return big


def test_fgsm_and_pgd_match_jax(pairs):
    """FGSM and PGD (no random start, 2 steps) on AlexNet: each step's
    input gradient at JAX's point within 2e-4 of its largest entry and of
    the same sign wherever |g| > 1e-4·max|g|; the adversarial images
    equal there and within the attack's reach elsewhere."""
    jm, v, tm = pairs["alexnet"]
    x, y = _images(4, seed=17), _labels(4, seed=17)
    k = jax.random.PRNGKey(0)
    jgrad = jax.jit(jax.grad(lambda a, vs: JAD._attack_loss(
        jm, vs, 1, a, jnp.asarray(y), k)))

    def grad(a):
        return jgrad(a, v)

    ys = torch.from_numpy(y)
    g1 = grad(jnp.asarray(x))
    big1 = _check_grad(TAD.input_grad(tm, _nchw(x), ys), g1)

    eps = 0.01
    # JAX's fgsm is xs + eps·sign of this same gradient (its eager grad
    # would compile every primitive of the backward pass one by one)
    want = (x + eps * np.sign(np.asarray(g1))).transpose(0, 3, 1, 2)
    got, got_y = TAD.fgsm(tm, _nchw(x), ys, eps=eps)
    assert got_y is ys
    np.testing.assert_allclose(got.numpy()[big1], want[big1], rtol=0,
                               atol=1e-6)
    assert np.abs(got.numpy() - want).max() <= 2 * eps + 1e-6

    eps, alpha = 0.03, 0.01
    x1 = np.asarray(jnp.asarray(x) + jnp.clip(
        alpha * jnp.sign(g1), -eps, eps))
    g2 = grad(jnp.asarray(x1))
    big2 = _check_grad(TAD.input_grad(tm, _nchw(x1), ys), g2)
    want, _ = JAD.pgd(jm, v, jnp.asarray(x), jnp.asarray(y), eps=eps,
                      alpha=alpha, steps=2, random_start=False, rng=k)
    got, _ = TAD.pgd(tm, _nchw(x), ys, eps=eps, alpha=alpha, steps=2,
                     random_start=False)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    both = big1 & np.transpose(np.abs(np.asarray(g2)) > 1e-4 * np.abs(
        np.asarray(g2)).max(), (0, 3, 1, 2))
    assert both.mean() > 0.9 and big2.mean() > 0.9
    np.testing.assert_allclose(got.numpy()[both], want[both], rtol=0,
                               atol=1e-6)
    assert np.abs(got.numpy() - _nchw(x).numpy()).max() <= eps + 1e-6


def test_pgd_start_clamp_and_random_attack_values(pairs):
    """PGD clamps to [0, 1] at its random start only; Random moves every
    value by exactly ±eps and ignores the model."""
    _, _, tm = pairs["alexnet"]
    x = _nchw(_images(2, seed=18) * 2)  # well outside [0, 1]
    ys = torch.from_numpy(_labels(2, seed=18))
    eps = 0.05
    start, _ = TAD.pgd(tm, x, ys, eps=eps, steps=0,
                       generator=torch.Generator().manual_seed(1))
    assert float(start.min()) >= 0.0 and float(start.max()) <= 1.0
    assert float((start - x.clamp(0, 1)).abs().max()) <= eps + 1e-6
    stepped, _ = TAD.pgd(tm, x, ys, eps=eps, alpha=0.01, steps=1,
                         generator=torch.Generator().manual_seed(1))
    assert float(stepped.min()) < 0.0 or float(stepped.max()) > 1.0
    assert float((stepped - x).abs().max()) <= eps + 1e-6
    a, _ = TAD.pgd(tm, x, ys, eps=eps, steps=2,
                   generator=torch.Generator().manual_seed(3))
    b, _ = TAD.pgd(tm, x, ys, eps=eps, steps=2,
                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    for got in (TAD.random_attack(x, ys, eps=eps)[0],
                np.asarray(JAD.random_attack(jnp.asarray(x.numpy()),
                                             jnp.asarray(ys.numpy()),
                                             eps=eps)[0])):
        d = np.abs(np.asarray(got) - x.numpy())
        np.testing.assert_allclose(d, eps, rtol=0, atol=1e-6)
    signs = np.sign(TAD.random_attack(x, ys, eps=eps)[0].numpy() - x.numpy())
    assert 0.4 < (signs > 0).mean() < 0.6


def test_freq_mask_and_freq_attack_match_jax():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    for f in (0.1, 0.8, 1.5, 2.5, 3.2):
        want = np.asarray(JAD.freq_mask(jnp.asarray(x), f))
        got = TAD.freq_mask(_nchw(x), f)
        np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-5)
    xs = _nchw(x)
    adv, _ = TAD.freq_attack(lambda a, b: (a + 0.1, b), xs, None, f=1.0)
    torch.testing.assert_close(adv, xs + TAD.freq_mask(
        torch.full_like(xs, 0.1), 1.0), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- fourier

@pytest.mark.parametrize("name", list(MODELS))
def test_latents_and_fourier_profiles_match_jax(pairs, name, tmp_path):
    """The taps in order (AlexNet's NCHW maps; ViT-Ti's [B, 17, C] tokens,
    whose cls token `_to_map` drops), the Δ log-amplitude profiles, the
    high-frequency deltas and the variances, against the JAX package on
    its NHWC latents; the two figures."""
    jm, v, tm = pairs[name]
    x = _images(4, seed=20)
    want = JF.collect_latents(_Jitted(jm), v, x)
    got = TF.collect_latents(tm, x)
    assert len(got) == len(want) == {"alexnet": 5, "vit_ti": 25}[name]
    for g, w in zip(got, want):
        if w.ndim == 4:
            w = w.transpose(0, 3, 1, 2)
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    for g, w in zip(TF.fourier_latents(got), JF.fourier_latents(want)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(TF.high_freq_deltas(got),
                               JF.high_freq_deltas(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(TF.variance_latents(got),
                               JF.variance_latents(want), rtol=TOL, atol=TOL)
    assert TF._to_map(got[-1]).shape[-2:] == ((4, 4) if name == "vit_ti"
                                              else got[-1].shape[-2:])
    with pytest.raises(ValueError, match="not square"):
        TF._to_map(np.zeros((1, 7, 4)))
    TF.save_fourier_plot(TF.fourier_latents(got), str(tmp_path / "f.png"),
                         title=name)
    TF.save_variance_plot(TF.variance_latents(got), str(tmp_path / "v.png"))
    assert (tmp_path / "f.png").exists() and (tmp_path / "v.png").exists()

