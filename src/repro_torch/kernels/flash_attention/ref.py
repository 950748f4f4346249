"""Plain torch attention: a direct masked softmax over absolute positions.

The reference for ``csrc/flash_attention.cu`` and the path the wrapper
takes for CPU tensors.  It is the model's attention function
(``models/layers.py`` ``_direct_attention`` in the reference package) in
the model layout, with the masks that take explicit positions:

* ``k_pos >= 0`` (−1 marks an empty cache slot),
* causal ``k_pos <= q_pos``,
* window ``k_pos > q_pos - window``.

Scores are f32; probabilities are cast to the input dtype before P·V.  A
row whose keys are all masked gets a uniform softmax, as in the reference
(the kernel writes 0 there; no caller produces such a row).
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
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, hq, d)


def live_mask(q_pos, k_pos, causal=True, window=None):
    """[S, T] bool: the (query, key) pairs the masks leave live."""
    mask = (k_pos >= 0)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def split_attention_ref(q, k, v, *, q_pos, k_pos, causal=True, window=None,
                        split=64):
    """The algebra of the kernel's split-key decode in plain torch (for
    tests): per split of ``split`` keys a partial ``(m, l, acc)`` (m = −inf,
    l = 0 where no key of the split is live for the row), then the splits
    merged in index order.  A row with no live key is 0 (the kernel's rule,
    not ``attention_ref``'s uniform softmax).  f32, [B,S,Hq,D]."""
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
                      torch.einsum("bhgst,bthd->bhgsd", p, v[:, sl].float())))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l_tot = torch.zeros_like(mx)
    acc = mx.new_zeros(*mx.shape, d)
    for m, l_j, a_j in parts:
        w = torch.where(m == -math.inf, 0.0, torch.exp(m - mx))
        l_tot = l_tot + w * l_j
        acc = acc + w[..., None] * a_j
    out = torch.where(l_tot[..., None] > 0,
                      acc / l_tot.clamp(min=1e-30)[..., None], 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d)


def rolled_pos_tab(t_max, first, last, empty=()):
    """The position table of a rolling cache (``transformer._KVView``) that
    has held positions ``first..last`` at slots ``pos % t_max``, with the
    slots listed in ``empty`` cleared to −1: int32 numpy ``[t_max]``."""
    tab = np.full(t_max, -1, np.int32)
    for p in range(first, last + 1):
        tab[p % t_max] = p
    tab[list(empty)] = -1
    return tab
