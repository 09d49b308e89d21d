"""Window attention: the plain torch twins of kernels K1 and K3, and W-MSA.

Counterpart of `dehaze_tpu/ops/probsparse.py` (`probsparse_u`,
`sample_indices`, `topu_row_mask_sorted`, the `layout="bnc"` path, and
`full_window_attention`, the single-softmax W-MSA that no TPU kernel
computes);
`probsparse_attention_bnc_bwd` is the plain twin of the K1 backward
(`_kernel_v4_bwd` of `dehaze_tpu/ops/pallas/window_attention.py`).
Semantics, per window and head:

1. S = QKᵀ, rounded to the activation dtype;
2. sparsity measure M = max over the sampled columns − Σ(cnt·S)/N, on the
   unscaled rounded S (cnt = how often each column was sampled per row);
3. the top-u rows by M (ties: lower index first) are kept;
4. a1 = softmax(S·scale), rounded to the activation dtype;
5. z = a1 + rel-pos bias[h] + mask, where the mask is −100 where SW region
   ids differ plus −100 where both tokens are padding (`pad_flag`, the
   reference's m⊗m product mask of any-resolution inputs);
6. a2 = softmax(z); kept rows get a2 @ V (a2 rounded to the activation
   dtype), the others mean(V).

The older TPU kernels (K3) compute the same chain but round at other
points, named by `numerics`:

| numerics | kernel | S | M on | a1 | PV |
|---|---|---|---|---|---|
| "v4" | `_kernel_v4` (K1) | rounded | S | rounded | a2 rounded |
| "v1" | `_kernel` | not rounded | S | not rounded | f32, a2 not rounded |
| "v23" | `_kernel_v2`, `_kernel_v3` | (q·scale rounded)·kᵀ, not rounded | scaled S | not rounded | a2 rounded |

In "v23" the scale is rounded to the activation dtype before q·scale (as
`jnp.asarray(scale, q.dtype)` does), and the backward forms dk from that
rounded, scaled q (`_kernel_v3_bwd`).

Exactness that keeps the row selection stable: S is accumulated in float64
and rounded once to float32 (then, in "v4", to the activation dtype), and
Σ(cnt·S) is summed in float64, so the selection does not depend on
summation order. The CUDA kernel (`csrc/window_attention.cu`) does the
same, which lets the two select identical rows on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dehaze_tpu_torch.ops.window import region_mask

NUMERICS = ("v4", "v1", "v23")


def probsparse_u(n: int, factor: int = 5) -> int:
    """u = min(factor * ceil(ln n), n)."""
    return min(int(factor * math.ceil(math.log(n))), n)


def sample_indices(n_q: int, n_k: int, u_part: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """[n_q, u_part] int32 random key columns in [0, n_k), shared across
    windows and heads, drawn on the generator's device (CPU by default).

    Module-level so tests can pin it (JAX's bits cannot be reproduced)."""
    return torch.randint(0, n_k, (n_q, u_part), generator=generator,
                         dtype=torch.int32)


def sample_count_matrix(sample_idx: torch.Tensor, n: int) -> torch.Tensor:
    """[N, U] sampled columns -> [N, N] float32 counts cnt[i, c]."""
    idx = sample_idx.to(torch.long)
    cnt = torch.zeros(idx.shape[0], n, dtype=torch.float32,
                      device=sample_idx.device)
    return cnt.scatter_add_(1, idx, torch.ones(idx.shape, dtype=torch.float32,
                                               device=sample_idx.device))


def _counts(sample_idx: Optional[torch.Tensor], cnt: Optional[torch.Tensor],
            n: int, device: torch.device) -> torch.Tensor:
    """float32 [n, n] sample counts on `device`: `cnt` (the kernels' int32
    count matrix) when given, else built from sample_idx."""
    if cnt is not None:
        return cnt.to(device=device, dtype=torch.float32)
    return sample_count_matrix(sample_idx.to(device), n)


def topu_row_mask_sorted(m: torch.Tensor, u: int) -> torch.Tensor:
    """Boolean mask [..., N] of the top-u entries of m; among equal values
    the lower index wins (no reliance on torch.topk's tie order)."""
    n = m.shape[-1]
    if u >= n:
        return torch.ones(m.shape, dtype=torch.bool, device=m.device)
    thr = torch.sort(m, dim=-1).values[..., n - u, None]
    gt = m > thr
    eq = m == thr
    n_gt = gt.sum(-1, keepdim=True)
    eq_i = eq.to(torch.int32)
    ties_before = torch.cumsum(eq_i, dim=-1) - eq_i
    return gt | (eq & (ties_before < (u - n_gt)))


def attention_mask(sw_region: Optional[torch.Tensor],
                   pad_flag: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
    """The additive [nW, N, N] float32 mask: −100 where the SW region ids
    differ, plus −100 where both tokens are padding (pad_flag [nW, N],
    nonzero on padding); None without either."""
    mask = None
    if sw_region is not None:
        mask = region_mask(sw_region)
    if pad_flag is not None:
        pf = pad_flag != 0
        pad = torch.where(pf[:, None, :] & pf[:, :, None], -100.0, 0.0).to(
            torch.float32)
        mask = pad if mask is None else mask + pad
    return mask


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scale(q: torch.Tensor, num_heads: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1] // num_heads) if scale is None \
        else scale


def _chain_bhnd(qh, kh, vh, sample_idx, rel_pos_bias, mask, factor, scale,
                numerics, cnt=None):
    """The chain up to the second softmax on [B, H, N, D] q/k/v in the
    activation dtype: (q as S saw it, k, v in the compute dtype, row_mask
    [B, H, N], a1 and a2 [B, H, N, N]). a1 is rounded in "v4" only; a2 is
    never rounded here (the forward rounds it before PV in "v4"/"v23").
    mask: additive [nW, N, N] or None. cnt: the [N, N] sample counts
    (`sample_count_matrix`) in place of sample_idx, or None."""
    if numerics not in NUMERICS:
        raise ValueError(f"numerics must be one of {NUMERICS}, got "
                         f"{numerics!r}")
    B, H, N, _ = qh.shape
    u = probsparse_u(N, factor)
    store_t = qh.dtype
    ct = _compute_dtype(qh)
    cnt = _counts(sample_idx, cnt, N, qh.device)
    if numerics == "v23":
        # q·scale in the activation dtype, the scale rounded to it first
        qh = qh * torch.tensor(scale, dtype=store_t, device=qh.device)
    s = torch.matmul(qh.double(), kh.double().transpose(-1, -2)).to(ct)
    if numerics == "v4":
        s = s.to(store_t).to(ct)                              # [B, H, N, N]

    m_max = torch.where(cnt > 0, s, torch.tensor(-1e30, dtype=ct,
                                                 device=s.device)).amax(-1)
    m_sum = (s.double() * cnt.double()).sum(-1).to(ct)
    row_mask = topu_row_mask_sorted(m_max - m_sum / N, u)     # [B, H, N]

    a1 = torch.softmax(s if numerics == "v23" else s * scale, dim=-1)
    if numerics == "v4":
        a1 = a1.to(store_t).to(ct)
    z = a1
    if rel_pos_bias is not None:
        z = z + rel_pos_bias.to(ct)[None]
    if mask is not None:
        nW = mask.shape[0]
        z = (z.reshape(B // nW, nW, H, N, N) + mask.to(ct)[None, :, None]
             ).reshape(B, H, N, N)
    a2 = torch.softmax(z, dim=-1)
    return qh.to(ct), kh.to(ct), vh.to(ct), row_mask, a1, a2


def _forward_bhnd(qh, kh, vh, sample_idx, rel_pos_bias, mask, factor, scale,
                  numerics, cnt=None):
    """[B, H, N, D] context in the compute dtype."""
    _, _, vf, row_mask, _, a2 = _chain_bhnd(
        qh, kh, vh, sample_idx, rel_pos_bias, mask, factor, scale, numerics,
        cnt)
    if numerics != "v1":
        a2 = a2.to(qh.dtype).to(vf.dtype)
    ctx = torch.matmul(a2, vf)
    v_mean = vf.mean(dim=-2, keepdim=True)
    return torch.where(row_mask[..., None], ctx, v_mean)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, D] (a view)."""
    B, N, C = t.shape
    return t.reshape(B, N, num_heads, C // num_heads).permute(0, 2, 1, 3)


def _tokens(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, C] in `dtype`."""
    B, H, N, D = t.shape
    return t.permute(0, 2, 1, 3).reshape(B, N, H * D).to(dtype)


def probsparse_attention_bnc(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_heads: int,
    sample_idx: Optional[torch.Tensor] = None,
    rel_pos_bias: Optional[torch.Tensor] = None,
    sw_region: Optional[torch.Tensor] = None,
    pad_flag: Optional[torch.Tensor] = None,
    factor: int = 5,
    scale: Optional[float] = None,
    numerics: str = "v4",
    cnt: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ProbSparse attention over window tokens, [B_, N, C] in and out, with
    heads as channel slices (C = num_heads · D).

    sample_idx: [N, U_part] int, or cnt: the [N, N] counts the kernels take
    (`sample_count_matrix`); rel_pos_bias: [H, N, N] or None; sw_region
    and pad_flag: [nW, N] region ids and padding flags, or None (B_ must
    then be a multiple of nW). numerics: "v4" (K1) or "v23" (K3-v3)."""
    out = _forward_bhnd(
        _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
        sample_idx, rel_pos_bias, attention_mask(sw_region, pad_flag), factor,
        _scale(q, num_heads, scale), numerics, cnt)
    return _tokens(out, v.dtype)


def probsparse_attention_bhnd(q, k, v, *, sample_idx, rel_pos_bias=None,
                              sw_region=None, factor=5, scale=None,
                              numerics="v4"):
    """ProbSparse attention over head-major q/k/v/out [B, H, N, D], B =
    nB·nW window-major, with any `numerics`."""
    return _forward_bhnd(q, k, v, sample_idx, rel_pos_bias,
                         attention_mask(sw_region, None), factor,
                         _scale(q, 1, scale), numerics).to(v.dtype)


def probsparse_attention_v1(q, k, v, **kw):
    """The plain twin of K3-v1 (`probsparse_window_attention_pallas`):
    `probsparse_attention_bhnd` with "v1" numerics."""
    return probsparse_attention_bhnd(q, k, v, numerics="v1", **kw)


def probsparse_attention_v2(q, k, v, **kw):
    """The plain twin of K3-v2 (`probsparse_window_attention_pallas_v2`):
    `probsparse_attention_bhnd` with "v23" numerics."""
    return probsparse_attention_bhnd(q, k, v, numerics="v23", **kw)


def probsparse_attention_bnc_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    *,
    num_heads: int,
    sample_idx: torch.Tensor,
    rel_pos_bias: Optional[torch.Tensor] = None,
    sw_region: Optional[torch.Tensor] = None,
    pad_flag: Optional[torch.Tensor] = None,
    factor: int = 5,
    scale: Optional[float] = None,
    numerics: str = "v4",
):
    """Gradients of `probsparse_attention_bnc` for the output gradient g
    [B_, N, C]: (dq, dk, dv) in q's dtype and dbias [H, N, N] float32 (None
    without a bias), the plain twin of the K1 backward ("v4") and of the
    K3-v3 backward ("v23").

    As `_kernel_v4_bwd` and `_kernel_v3_bwd` do: g is rounded to the
    activation dtype first, the chain is recomputed (same selection as the
    forward), and the roundings pass the gradient straight through (a1 is
    used as the forward used it, a2 unrounded). Unselected rows feed only
    the mean(V) term. dq = (ds·k)·scale; dk = dsᵀ·q·scale in "v4" and
    dsᵀ·(q·scale rounded) in "v23"."""
    N = q.shape[1]
    scale = _scale(q, num_heads, scale)
    qf, kf, vf, row_mask, a1, a2 = _chain_bhnd(
        _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
        sample_idx, rel_pos_bias, attention_mask(sw_region, pad_flag), factor,
        scale, numerics)
    gh = _heads(g.to(q.dtype), num_heads).to(qf.dtype)
    g_sel = gh * row_mask[..., None]
    g_unsel = gh - g_sel
    dv = (torch.matmul(a2.transpose(-1, -2), g_sel)
          + g_unsel.sum(-2, keepdim=True) / N)
    da2 = torch.matmul(g_sel, vf.transpose(-1, -2))
    dz = a2 * (da2 - (da2 * a2).sum(-1, keepdim=True))
    dbias = dz.sum(0) if rel_pos_bias is not None else None
    ds = a1 * (dz - (dz * a1).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    if numerics != "v23":
        dk = dk * scale
    return (_tokens(dq, q.dtype), _tokens(dk, q.dtype), _tokens(dv, q.dtype),
            dbias)


def _widen(t: torch.Tensor, m: int) -> torch.Tensor:
    """[..., N] → [..., M] by repeating each column M // N times in place
    (column j → columns ratio·j … ratio·j + ratio − 1): the reference's
    interleaving `repeat('... c -> ... (c d)')`, not a tiling."""
    return t if t.shape[-1] == m else t.repeat_interleave(m // t.shape[-1],
                                                          dim=-1)


def full_window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    rel_pos_bias: Optional[torch.Tensor] = None,
    sw_mask: Optional[torch.Tensor] = None,
    sw_region: Optional[torch.Tensor] = None,
    pad_flag: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    layout: str = "bhnd",
) -> torch.Tensor:
    """W-MSA / SW-MSA with one softmax: softmax(q·kᵀ·scale + bias + mask)
    @ v, per window and head (the reference's `My_model.py` attention).

    q: [B, H, N, D] ("bhnd") or [B, N, H, D] ("bnhd"); k and v carry M
    tokens, M = N or, for token_projection='linear_concat', 2N. The
    scores and the softmax are float32 (float64 for float64 inputs), q and
    k cast up first, as the JAX einsum with preferred_element_type=f32
    keeps them; the probabilities are rounded to v's dtype for P·V.
    rel_pos_bias: [H, N, N] or [H, N, M]. The mask: sw_mask [nW, N, N],
    or −100 where sw_region ids [nW, N] differ, plus −100 where both tokens
    are padding (pad_flag [nW, N]); B must be a multiple of nW. An N-wide
    bias or mask is widened to M by `_widen` (the reference's quirk, kept).
    Returns the layout of q, in v's dtype."""
    token_major = layout == "bnhd"
    if token_major:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    B, H, N, D = q.shape
    M = k.shape[2]
    ct = _compute_dtype(q)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)).mul_(scale)
    if rel_pos_bias is not None:
        s += _widen(rel_pos_bias, M).to(ct)
    if sw_mask is None:
        mask = attention_mask(sw_region, pad_flag)
    else:
        pad = attention_mask(None, pad_flag)
        mask = sw_mask if pad is None else sw_mask + pad
    if mask is not None:
        nW = mask.shape[0]
        s.view(B // nW, nW, H, N, M).add_(_widen(mask, M).to(ct)[None, :,
                                                                  None])
    out = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
    return out.transpose(1, 2) if token_major else out
