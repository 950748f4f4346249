"""Plain torch chunked SSD scan: the reference for ``csrc/ssd_scan.cu`` and
the path the wrapper takes for CPU tensors.

A port of the reference model's ``mamba2.ssd_chunked``: the intra-chunk
dual form and the per-chunk states are batched over all chunks, and the
inter-chunk recurrence is a loop over chunks.  With ``cum`` the cumsum of
``dt·a`` inside a chunk of Q steps:

    intra:  Y[i] += Σ_{j≤i} (C_i·B_j)·exp(min(cum_i−cum_j, 0))·dt_j·x_j
    state:  S_c   = exp(cum_end)·S_{c−1} + Σ_j exp(cum_end−cum_j)·dt_j·B_j⊗x_j
    inter:  Y[i] += C_i · S_{c−1} · exp(cum_i)

The exponent is clamped at 0 so the masked upper triangle cannot overflow;
the tail is padded with zeros (dt = 0, so it moves no state).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def ssd_ref(x, dt, a, b, c, *, chunk: int = 128, init_state=None):
    """x [B,S,H,P], dt [B,S,H] (post-softplus), a [H] (negative),
    b/c [B,S,G,N], init_state [B,H,P,N] or None →
    (y [B,S,H,P], final state [B,H,P,N] f32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bh = b.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    ch = c.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    cum = torch.cumsum(dtc * a, dim=2)                 # [B,nc,Q,H]
    cum_end = cum[:, :, -1]                            # [B,nc,H]

    scores = torch.einsum("bcqhn,bckhn->bchqk", ch.float(), bh.float())
    cum_h = cum.permute(0, 1, 3, 2)                    # [B,nc,H,Q]
    decay = torch.exp(torch.clamp(
        cum_h[..., :, None] - cum_h[..., None, :], max=0.0))
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    gmat = torch.where(causal, scores * decay, 0.0)
    xdt = xc * dtc[..., None]
    y = torch.einsum("bchqk,bckhp->bcqhp", gmat.to(x.dtype), xdt)

    w_end = torch.exp(cum_end[:, :, None, :] - cum)    # [B,nc,Q,H]
    s_chunk = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", bh, xdt,
                           w_end.to(x.dtype))

    state = (torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    entry = []
    for ci in range(nc):
        entry.append(state)
        state = (torch.exp(cum_end[:, ci])[:, :, None, None] * state
                 + s_chunk[:, ci].float())
    entry_states = torch.stack(entry, dim=1)           # [B,nc,H,P,N]

    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", ch,
                           entry_states.to(x.dtype),
                           torch.exp(cum).to(x.dtype))
    y = (y + y_inter).reshape(bsz, nc * chunk, h, p)
    return y[:, :s], state


def random_inputs(seed, b, s, h, p, g, n):
    """Seeded f32 numpy inputs at the scales of the reference's SSD tests:
    (x [B,S,H,P], dt [B,S,H] > 0, a [H] < 0, b/c [B,S,G,N], a state
    [B,H,P,N])."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return ((rng.standard_normal((b, s, h, p)) * 0.5).astype(f32),
            (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.3)
            .astype(f32),
            (-np.exp(rng.standard_normal(h) * 0.3)).astype(f32),
            (rng.standard_normal((b, s, g, n)) * 0.4).astype(f32),
            (rng.standard_normal((b, s, g, n)) * 0.4).astype(f32),
            (rng.standard_normal((b, h, p, n)) * 0.3).astype(f32))
