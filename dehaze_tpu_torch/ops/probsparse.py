"""ProbSparse window attention — the plain torch twins of kernel K1.

Counterpart of `dehaze_tpu/ops/probsparse.py` (`probsparse_u`,
`sample_indices`, `topu_row_mask_sorted`, and the `layout="bnc"` path);
`probsparse_attention_bnc_bwd` is the plain twin of the K1 backward
(`_kernel_v4_bwd` of `dehaze_tpu/ops/pallas/window_attention.py`).
Semantics, per window and head:

1. S = QKᵀ, rounded to the activation dtype;
2. sparsity measure M = max over the sampled columns − Σ(cnt·S)/N, on the
   unscaled rounded S (cnt = how often each column was sampled per row);
3. the top-u rows by M (ties: lower index first) are kept;
4. a1 = softmax(S·scale), rounded to the activation dtype;
5. z = a1 + rel-pos bias[h] (+ −100 where SW region ids differ);
6. a2 = softmax(z); kept rows get a2 @ V, the others mean(V).

Exactness that keeps the row selection stable: S is accumulated in float64
and rounded once to float32 (then to the activation dtype), and Σ(cnt·S) is
summed in float64, so the selection does not depend on summation order. The
CUDA kernel (`csrc/window_attention.cu`) does the same, which lets the two
select identical rows on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dehaze_tpu_torch.ops.window import region_mask


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


def _chain(q, k, v, num_heads, sample_idx, rel_pos_bias, sw_region, factor,
           scale):
    """The forward chain up to the second softmax, per window and head:
    (qh, kh, vh [B, H, N, D], row_mask [B, H, N], a1 rounded, a2
    unrounded [B, H, N, N]), in float32 (float64 for float64 inputs, which
    only the finite-difference tests pass)."""
    B, N, C = q.shape
    H = num_heads
    D = C // H
    u = probsparse_u(N, factor)
    store_t = q.dtype
    ct = _compute_dtype(q)

    def heads(t):  # [B, N, C] -> [B, H, N, D]
        return t.reshape(B, N, H, D).permute(0, 2, 1, 3)

    qh, kh, vh = heads(q), heads(k), heads(v)
    s = torch.matmul(qh.double(), kh.double().transpose(-1, -2)).to(ct)
    s = s.to(store_t).to(ct)                                  # [B, H, N, N]

    cnt = sample_count_matrix(sample_idx.to(q.device), N)
    m_max = torch.where(cnt > 0, s, torch.tensor(-1e30, dtype=ct,
                                                 device=s.device)).amax(-1)
    m_sum = (s.double() * cnt.double()).sum(-1).to(ct)
    row_mask = topu_row_mask_sorted(m_max - m_sum / N, u)     # [B, H, N]

    a1 = torch.softmax(s * scale, dim=-1).to(store_t).to(ct)
    z = a1
    if rel_pos_bias is not None:
        z = z + rel_pos_bias.to(ct)[None]
    if sw_region is not None:
        nW = sw_region.shape[0]
        mask = region_mask(sw_region.to(q.device))            # [nW, N, N]
        z = (z.reshape(B // nW, nW, H, N, N) + mask[None, :, None]
             ).reshape(B, H, N, N)
    a2 = torch.softmax(z, dim=-1)
    return qh.to(ct), kh.to(ct), vh.to(ct), row_mask, a1, a2


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scale(q: torch.Tensor, num_heads: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1] // num_heads) if scale is None \
        else scale


def probsparse_attention_bnc(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_heads: int,
    sample_idx: torch.Tensor,
    rel_pos_bias: Optional[torch.Tensor] = None,
    sw_region: Optional[torch.Tensor] = None,
    factor: int = 5,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """ProbSparse attention over window tokens, [B_, N, C] in and out, with
    heads as channel slices (C = num_heads · D).

    sample_idx: [N, U_part] int; rel_pos_bias: [H, N, N] or None; sw_region:
    [nW, N] region ids or None (B_ must then be a multiple of nW)."""
    B, N, C = q.shape
    _, _, vf, row_mask, _, a2 = _chain(
        q, k, v, num_heads, sample_idx, rel_pos_bias, sw_region, factor,
        _scale(q, num_heads, scale))
    ctx = torch.matmul(a2.to(q.dtype).to(vf.dtype), vf)
    v_mean = vf.mean(dim=-2, keepdim=True)
    out = torch.where(row_mask[..., None], ctx, v_mean).to(v.dtype)
    return out.permute(0, 2, 1, 3).reshape(B, N, C)


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
    factor: int = 5,
    scale: Optional[float] = None,
):
    """Gradients of `probsparse_attention_bnc` for the output gradient g
    [B_, N, C]: (dq, dk, dv) in q's dtype and dbias [H, N, N] float32 (None
    without a bias), the plain twin of the K1 backward.

    As `_kernel_v4_bwd` does: g is rounded to the activation dtype first,
    the chain is recomputed (same selection as the forward), and the
    roundings of a1 and a2 pass the gradient straight through (a1 is used
    rounded, a2 unrounded). Unselected rows feed only the mean(V) term."""
    B, N, C = q.shape
    H = num_heads
    D = C // H
    scale = _scale(q, num_heads, scale)
    qf, kf, vf, row_mask, a1, a2 = _chain(
        q, k, v, num_heads, sample_idx, rel_pos_bias, sw_region, factor,
        scale)
    gh = g.to(q.dtype).reshape(B, N, H, D).permute(0, 2, 1, 3).to(qf.dtype)
    g_sel = gh * row_mask[..., None]
    g_unsel = gh - g_sel
    dv = (torch.matmul(a2.transpose(-1, -2), g_sel)
          + g_unsel.sum(-2, keepdim=True) / N)
    da2 = torch.matmul(g_sel, vf.transpose(-1, -2))
    dz = a2 * (da2 - (da2 * a2).sum(-1, keepdim=True))
    dbias = dz.sum(0) if rel_pos_bias is not None else None
    ds = a1 * (dz - (dz * a1).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale

    def tokens(t):  # [B, H, N, D] -> [B, N, C] in the activation dtype
        return t.permute(0, 2, 1, 3).reshape(B, N, C).to(q.dtype)

    return tokens(dq), tokens(dk), tokens(dv), dbias
