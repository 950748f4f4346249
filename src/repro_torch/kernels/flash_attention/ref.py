"""Plain torch attention: a direct masked softmax over absolute positions.

The reference for ``csrc/flash_attention.cu`` and the path the wrapper
takes for CPU tensors (autograd runs through it there).
:func:`attention_lse_ref` and :func:`attention_bwd_ref` mirror the
kernel's log-sum-exp output and its backward (the latter in f32, also
with the f32 kernel's 3xTF32 products, :func:`einsum_3xtf32`, and in
bf16 with the bf16 kernel's rounding); :func:`attention_bwd_tiled_ref`
also keeps the bf16 backward kernel's order of f32 sums (dQ by key
tiles, dK and dV by the heads of a group).  It is the model's
attention function (``models/layers.py`` ``_direct_attention`` in the
reference package) in the model layout, with the masks that take
explicit positions:

* ``k_pos >= 0`` (−1 marks an empty cache slot),
* causal ``k_pos <= q_pos``,
* window ``k_pos > q_pos - window``.

Scores are f32.  In f32, probabilities are normalised and then P·V taken,
as in the reference's ``_direct_attention``.  In bf16 (q, k and v of one
type) the algebra is the kernel's and the Pallas kernel's
(``kernel.py:62-84``): f32 scores from the bf16 inputs, the unnormalised
P = exp(s − max) rounded to bf16 before P·V, the sum of P and the
accumulator in f32, one rounding of the normalised result to bf16.  (The
reference model's XLA attention rounds the normalised probabilities
instead, ``layers.py:137``; the two differ by bf16 rounding.)  A row whose
keys are all masked gets a uniform softmax, as in the reference (the kernel
writes 0 there; no caller produces such a row).
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, q_pos, k_pos, causal=True, window=None):
    """q [B,S,Hq,D], k/v [B,T,Hkv,D], q_pos [S] / k_pos [T] int →
    [B,S,Hq,D] in q's dtype.  Query head h reads KV head h // (Hq/Hkv)."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, s, hk, hq // hk, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())
    scores = scores / math.sqrt(d)
    mask = live_mask(q_pos, k_pos, causal, window)
    scores = scores.masked_fill(~mask, NEG_INF)
    if q.dtype == torch.float32:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    else:
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        acc = torch.einsum("bhgst,bthd->bhgsd", p.to(q.dtype).float(),
                           v.float())
        out = (acc / p.sum(-1)[..., None]).to(q.dtype).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, hq, d)


def attention_lse_ref(q, k, *, q_pos, k_pos, causal=True, window=None):
    """Each row's log-sum-exp of scaled live scores, f32 ``[B,Hq,S]``
    (−inf for a row with no live key): what the prefill entry point writes
    for the backward."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    qg = q.float().reshape(b, s, hk, hq // hk, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(d)
    scores = scores.masked_fill(~live_mask(q_pos, k_pos, causal, window),
                                -math.inf)
    return torch.logsumexp(scores, dim=-1).reshape(b, hq, s)


def tf32_split(x):
    """f32 ``x`` as two TF32 numbers ``(hi, lo)``: ``hi`` is x with the low
    13 bits of its mantissa cleared, ``lo`` the same of x − hi (which is
    exact), so x ≈ hi + lo to about 2⁻²⁰ of |x|."""
    mask = torch.tensor(-8192, dtype=torch.int32)          # 0xffffe000
    hi = (x.contiguous().view(torch.int32) & mask).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & mask).view(torch.float32)
    return hi, lo


def einsum_3xtf32(eq, a, b):
    """``torch.einsum(eq, a, b)`` as the backward kernel's tensor cores take
    it (3xTF32): a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each product of two
    TF32 numbers exact in f32, summed in f32; a_lo·b_lo dropped."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def attention_bwd_ref(q, k, v, out, dout, lse, *, q_pos, k_pos, causal=True,
                      window=None, tf32x3=False):
    """The algebra of the kernel's backward in plain torch: P recomputed
    from the saved log-sum-exp ``lse [B,Hq,S]``, D = rowsum(dO∘O), then
    dV = Pᵀ·dO, dS = P∘(dO·Vᵀ − D), dQ = dS·K / √D and dK = dSᵀ·Q / √D,
    with dK and dV summed over the query heads of a KV group.  Returns
    ``(dq [B,S,Hq,D], dk [B,T,Hkv,D], dv [B,T,Hkv,D])`` in q's type.

    f32 inputs: every product in f32, or with ``tf32x3`` as the f32
    kernel's tensor cores take them (:func:`einsum_3xtf32`; for tests).
    bf16 inputs (q, k, v, the forward's bf16 ``out`` and ``dout``; ``lse``
    f32): the bf16 kernel's rounding.  Every product takes bf16 operands
    and sums in f32: S and dP from the inputs as they are, dV from P
    rounded to bf16, dQ and dK from dS rounded to bf16 (P and dS are
    formed in f32 first); D from the bf16 ``out`` and ``dout`` in f32; dq,
    dk and dv rounded to bf16 once, dk and dv after the group's sum."""
    b, s, hq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qg, dog, kf, p, ds, mm = _bwd_terms(q, k, v, out, dout, lse, q_pos,
                                        k_pos, causal, window, tf32x3)
    dv = mm("bhgst,bshgd->bthd", p, dog)
    dq = mm("bhgst,bthd->bshgd", ds, kf) * scale
    dk = mm("bhgst,bshgd->bthd", ds, qg) * scale
    return dq.reshape(b, s, hq, d).to(q.dtype), dk.to(q.dtype), \
        dv.to(q.dtype)


def _bwd_terms(q, k, v, out, dout, lse, q_pos, k_pos, causal, window,
               tf32x3):
    """The backward's operands as the kernels take them: q and dout by
    group ``[B,S,Hkv,G,D]``, k in f32, P and dS ``[B,Hkv,G,S,T]`` (rounded
    to bf16 for bf16 inputs) and the product function."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    mm = einsum_3xtf32 if tf32x3 else torch.einsum
    bf16 = q.dtype == torch.bfloat16

    def operand(x):  # a product's operand as the kernel takes it
        return x.to(torch.bfloat16).float() if bf16 else x
    qg = q.float().reshape(b, s, hk, g, d)
    dog = dout.float().reshape(b, s, hk, g, d)
    kf, vf = k.float(), v.float()
    live = live_mask(q_pos, k_pos, causal, window)
    scores = mm("bshgd,bthd->bhgst", qg, kf) * (1.0 / math.sqrt(d))
    m = lse.reshape(b, hk, g, s)[..., None]
    p = torch.where(live, torch.exp(scores - m), 0.0)
    delta = (dog * out.float().reshape(b, s, hk, g, d)).sum(-1)
    dp = mm("bshgd,bthd->bhgst", dog, vf)
    ds = operand(p * (dp - delta.permute(0, 2, 3, 1)[..., None]))
    return qg, dog, kf, operand(p), ds, mm


def attention_bwd_tiled_ref(q, k, v, out, dout, lse, *, q_pos, k_pos,
                            causal=True, window=None, key_tile=128):
    """:func:`attention_bwd_ref` with the bf16 backward kernel's order of
    f32 sums: dQ as the sum of the shares of key tiles of ``key_tile``
    keys (dS[:, tile]·K[tile] in f32), the first stored and each next one
    added in key-tile order, then scaled by 1/√D; dK and dV as the sum of
    each query head's share (dSᵀ·Q / √D and Pᵀ·dO in f32) over the heads of
    a group, in head order.  Each gradient rounded to q's type once.  A row
    with no live key gets dq = 0 and a key with no live query dk = dv = 0,
    exactly, as in :func:`attention_bwd_ref`."""
    b, s, hq, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg, dog, kf, p, ds, mm = _bwd_terms(q, k, v, out, dout, lse, q_pos,
                                        k_pos, causal, window, False)
    dq = None
    for t0 in range(0, t, key_tile):
        share = mm("bhgst,bthd->bshgd", ds[..., t0:t0 + key_tile],
                   kf[:, t0:t0 + key_tile])
        dq = share if dq is None else dq + share
    dk_h = mm("bhgst,bshgd->bthgd", ds, qg) * scale
    dv_h = mm("bhgst,bshgd->bthgd", p, dog)
    dk, dv = dk_h[..., 0, :], dv_h[..., 0, :]
    for r in range(1, hq // hk):
        dk, dv = dk + dk_h[..., r, :], dv + dv_h[..., r, :]
    return (dq * scale).reshape(b, s, hq, d).to(q.dtype), dk.to(q.dtype), \
        dv.to(q.dtype)


def live_mask(q_pos, k_pos, causal=True, window=None):
    """[S, T] bool: the (query, key) pairs the masks leave live."""
    mask = (k_pos >= 0)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def live_tile_range(k_pos, q_lo: int, q_hi: int, causal: bool,
                    window: int, tile: int) -> tuple[int, int]:
    """The range the kernels' ``live_tile_range`` finds (by a 32-way warp
    search) for a non-decreasing ``k_pos`` [T], here by
    ``torch.searchsorted``: ``(begin, end)``, the key tiles of ``tile``
    keys (counted from key 0) with starts in ``[begin, end)`` that a block
    over query positions ``[q_lo, q_hi]`` walks; ``window`` <= 0 is none.
    Without a causal mask or a window, every tile ``(0, T)``.  Else the
    keys that can be live for some row form one run, from the first whose
    position is at or past ``q_lo - window + 1`` (or 0) to the last at or
    below ``q_hi`` (causal): ``begin`` is the tile holding the first,
    ``end`` one past the last, ``(T, T)`` for an empty run."""
    t = k_pos.numel()
    if not causal and window <= 0:
        return 0, t
    first = int(torch.searchsorted(
        k_pos, max(0, q_lo - window + 1) if window > 0 else 0))
    stop = int(torch.searchsorted(k_pos, q_hi + 1)) if causal else t
    if first < stop:
        return first // tile * tile, stop
    return t, t


def split_attention_ref(q, k, v, *, q_pos, k_pos, causal=True, window=None,
                        split=64):
    """The algebra of the kernel's split-key decode in plain torch (for
    tests): per split of ``split`` keys a partial ``(m, l, acc)`` (m = −inf,
    l = 0 where no key of the split is live for the row), then the splits
    merged in index order.  A row with no live key is 0 (the kernel's rule,
    not ``attention_ref``'s uniform softmax).  Scores, partials and merge
    in f32, with P rounded to q's type before P·V; [B,S,Hq,D] in q's
    type."""
    b, s, hq, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, hk, hq // hk, d)
    live = live_mask(q_pos, k_pos, causal, window)          # [S, T]
    parts = []
    for t0 in range(0, t, split):
        sl = slice(t0, min(t, t0 + split))
        sc = torch.einsum("bshgd,bthd->bhgst", qg, k[:, sl].float())
        sc = (sc / math.sqrt(d)).masked_fill(~live[:, sl], -math.inf)
        m = sc.amax(-1)                                      # [B,Hk,G,S]
        p = torch.where(live[:, sl], torch.exp(sc - m[..., None].clamp(
            min=torch.finfo(torch.float32).min)), 0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bhgst,bthd->bhgsd",
                                   p.to(q.dtype).float(), v[:, sl].float())))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l_tot = torch.zeros_like(mx)
    acc = mx.new_zeros(*mx.shape, d)
    for m, l_j, a_j in parts:
        w = torch.where(m == -math.inf, 0.0, torch.exp(m - mx))
        l_tot = l_tot + w * l_j
        acc = acc + w[..., None] * a_j
    out = torch.where(l_tot[..., None] > 0,
                      acc / l_tot.clamp(min=1e-30)[..., None], 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def rolled_pos_tab(t_max, first, last, empty=()):
    """The position table of a rolling cache (``transformer._KVView``) that
    has held positions ``first..last`` at slots ``pos % t_max``, with the
    slots listed in ``empty`` cleared to −1: int32 numpy ``[t_max]``."""
    tab = np.full(t_max, -1, np.int32)
    for p in range(first, last + 1):
        tab[p % t_max] = p
    tab[list(empty)] = -1
    return tab
