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
    mask = (k_pos >= 0)[None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, hq, d)


def rolled_pos_tab(t_max, first, last, empty=()):
    """The position table of a rolling cache (``transformer._KVView``) that
    has held positions ``first..last`` at slots ``pos % t_max``, with the
    slots listed in ``empty`` cleared to −1: int32 numpy ``[t_max]``."""
    tab = np.full(t_max, -1, np.int32)
    for p in range(first, last + 1):
        tab[p % t_max] = p
    tab[list(empty)] = -1
    return tab
