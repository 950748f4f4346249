"""Plain torch chunked SSD scan: the reference for ``csrc/ssd_scan.cu`` and
the path the wrapper takes for CPU tensors.

A port of the reference model's ``mamba2.ssd_chunked``: the intra-chunk
dual form and the per-chunk states are batched over all chunks, and the
inter-chunk recurrence is a loop over chunks.  With ``cum`` the cumsum of
``dt·a`` inside a chunk of Q steps:

    intra:  Y[i] += Σ_{j≤i} (C_i·B_j)·exp(min(cum_i−cum_j, 0))·dt_j·x_j
    state:  S_c   = exp(cum_end)·S_{c−1} + Σ_j exp(cum_end−cum_j)·dt_j·B_j⊗x_j
    inter:  Y[i] += C_i · S_{c−1} · exp(cum_i)

The exponent is clamped at 0 so the masked upper triangle cannot overflow,
by ``torch.minimum``, whose gradient splits a tie evenly as JAX's does: the
diagonal's equal and opposite terms of the cumsum's gradient then enter at
half weight, as in the reference, and not at the full weight of
``torch.clamp``'s.  The tail is padded with zeros (dt = 0, so it moves no
state).

In bf16 (x, b and c; dt, a and the state stay f32) the algebra is the
Pallas kernel's (``kernel.py:36-40``, ``:75``): the inputs are converted to
f32, everything after runs in f32, and y is rounded to x's type once.
With ``tensor_cores`` the products are taken as the bf16 kernel's tensor
cores take them (:func:`einsum_2xtf32`; for tests).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..flash_attention.ref import einsum_3xtf32, tf32_split


def einsum_2xtf32(eq, a, b):
    """``torch.einsum(eq, a, b)`` as the bf16 forward's tensor cores take
    it: ``a`` f32, split into TF32 hi + lo (:func:`tf32_split`), ``b`` exact
    in TF32 (a bf16 value, whole): a_lo·b + a_hi·b, each product exact in
    f32, summed in f32."""
    hi, lo = tf32_split(a)
    return torch.einsum(eq, lo, b) + torch.einsum(eq, hi, b)


def bf16_split3(x):
    """f32 ``x`` as three bf16 tensors ``(hi, mid, lo)``: hi = bf16(x), mid
    = bf16(x − hi), lo = bf16(x − hi − mid), each rounded to nearest.  The
    two differences are exact in f32, and hi + mid + lo equals x exactly
    (24 bits of mantissa in three of 8) unless lo falls below bf16's
    normal range."""
    hi = x.bfloat16()
    r = x - hi.float()
    mid = r.bfloat16()
    return hi, mid, (r - mid.float()).bfloat16()


def einsum_3xbf16(eq, a, b):
    """``torch.einsum(eq, a, b)`` as the bf16 backward's ``wgmma`` takes
    it: ``a`` f32, split into three bf16 parts (:func:`bf16_split3`), ``b``
    bf16 values (whole): lo·b + mid·b + hi·b, each product exact in f32,
    summed in f32, the small terms first."""
    hi, mid, lo = bf16_split3(a)
    return (torch.einsum(eq, lo.float(), b) + torch.einsum(eq, mid.float(), b)
            + torch.einsum(eq, hi.float(), b))


def ssd_ref(x, dt, a, b, c, *, chunk: int = 128, init_state=None,
            tensor_cores=False):
    """x [B,S,H,P], dt [B,S,H] (post-softplus), a [H] (negative),
    b/c [B,S,G,N], init_state [B,H,P,N] or None →
    (y [B,S,H,P] in x's type, final state [B,H,P,N] f32).  With
    ``tensor_cores`` and bf16 inputs, the intra-chunk product, the chunk
    states and the inter-chunk term keep their bf16 side (x, B, C) whole
    and split their f32 side (C·Bᵀ∘decay∘dt, exp(cum_end − cum)·dt·x, the
    entry states) as the kernel does; C·Bᵀ is exact either way."""
    y_dtype = x.dtype
    split = tensor_cores and y_dtype == torch.bfloat16
    x, b, c = x.float(), b.float(), c.float()
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
    decay = torch.exp(torch.minimum(
        cum_h[..., :, None] - cum_h[..., None, :], cum_h.new_zeros(())))
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    gmat = torch.where(causal, scores * decay, 0.0)
    xdt = xc * dtc[..., None]
    w_end = torch.exp(cum_end[:, :, None, :] - cum)    # [B,nc,Q,H]
    if split:
        y = einsum_2xtf32("bchqk,bckhp->bcqhp",
                          gmat * dtc.permute(0, 1, 3, 2)[:, :, :, None], xc)
        s_chunk = einsum_2xtf32("bcqhp,bcqhn->bchpn",
                                (dtc * w_end)[..., None] * xc, bh)
    else:
        y = torch.einsum("bchqk,bckhp->bcqhp", gmat.to(x.dtype), xdt)
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

    if split:
        y_inter = torch.exp(cum)[..., None] * einsum_2xtf32(
            "bchpn,bcqhn->bcqhp", entry_states, ch)
    else:
        y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", ch,
                               entry_states.to(x.dtype),
                               torch.exp(cum).to(x.dtype))
    y = (y + y_inter).reshape(bsz, nc * chunk, h, p)
    return y[:, :s].to(y_dtype), state


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


def random_cotangents(seed, b, s, h, p, n):
    """Seeded f32 numpy cotangents of :func:`ssd_ref`'s outputs: dy
    [B,S,H,P] and that of the final state [B,H,P,N] (at half the scale)."""
    rng = np.random.default_rng(seed + 1000)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32))


def autograd_grads(fn, args, init, dy, dstate, *, chunk: int = 128):
    """``(dx, ddt, da, db, dc, dinit)`` of ``fn`` (with :func:`ssd_ref`'s
    signature) at ``args = (x, dt, a, b, c)`` and ``init`` (or None) by
    torch autograd, given the cotangents ``dy`` and ``dstate``; with
    ``dstate`` None only y is differentiated (the state's cotangent is
    absent, as on the train path).  ``dinit`` is None without ``init``."""
    leaves = [t.clone().requires_grad_(True)
              for t in (*args, *(() if init is None else (init,)))]
    y, state = fn(*leaves[:5], chunk=chunk,
                  init_state=None if init is None else leaves[5])
    torch.autograd.backward((y, state) if dstate is not None else (y,),
                            (dy, dstate) if dstate is not None else (dy,))
    return [t.grad for t in leaves] + [None] * (6 - len(leaves))


def ssd_bwd_ref(x, dt, a, b, c, dy, dstate, *, chunk: int = 128,
                init_state=None, tf32x3=False, tensor_cores=False):
    """The algebra of the kernel's backward in plain torch (not autograd):
    the gradients of :func:`ssd_ref`'s ``(y, final state)`` given their
    cotangents ``dy [B,S,H,P]`` and ``dstate [B,H,P,N]`` (or None, a zero
    cotangent).  Returns f32 ``(dx, ddt, da, db, dc, dinit)``; ``dinit`` is
    None without an ``init_state``.  The products are grouped as the
    kernel's: exp(cum) enters the aggregate's dy, dt enters u, the state
    terms of dC, dB and du scale their rows after the product.  With
    ``tf32x3`` each product is taken as the kernel's tensor cores take it
    (:func:`einsum_3xtf32`; for tests), else in f32.

    bf16 inputs (x, b, c and dy; dt, a, the states and ``dstate`` f32):
    the bf16 kernel's rounding, which is the f32 algebra on the inputs as
    they are (every product of two bf16 values is exact in f32, the f32
    side of the others kept whole to the order of its sums) with dx, db
    and dc rounded to bf16 once; ddt, da and dinit stay f32.  With
    ``tensor_cores`` (bf16 inputs only) each product is taken as the
    kernel's ``wgmma`` takes it: dy·xᵀ on the bf16 values with dt_j and E
    after, every other product with its f32 side split into three bf16
    parts (:func:`einsum_3xbf16`; for tests).

    Per chunk, with u = dt·x, E_ij = exp(min(cum_i − cum_j, 0)) for j ≤ i,
    M_ij = C_i·B_j (per group), S_{c−1} the state entering the chunk and
    Ŝ_c the cotangent of the state leaving it:

        reverse pass: Ŝ_{c−1} = exp(cum_end)·Ŝ_c + Σ_i exp(cum_i)·dy_i⊗C_i,
                      from dstate; dinit = Ŝ_{−1}
        du_j  = Σ_{i≥j} M_ij E_ij dy_i + exp(cum_end − cum_j)·Ŝ_c B_j
        dx_j  = dt_j·du_j,  ddt_j = x_j·du_j + a·dl_j
        dM_ij = Σ_{h∈group} E_ij (dy_i·u_j)          (heads in order)
        dC_i  = Σ_j dM_ij B_j + Σ_h exp(cum_i)·S_{c−1}ᵀ dy_i
        dB_j  = Σ_i dM_ij C_i + Σ_h exp(cum_end − cum_j)·dt_j·Ŝ_cᵀ x_j
        dcum  = rowsum(M∘dMʰ) − colsum(M∘dMʰ) (the diagonal left out: it
                adds g and −g to one entry) + C_i·dC_iʰ (dC_iʰ the head's
                state term of dC, exp(cum_i)·S_{c−1}ᵀ dy_i) − w_j,
                w_j = exp(cum_end − cum_j)·u_j·(Ŝ_c B_j), and
                exp(cum_end)·⟨Ŝ_c, S_{c−1}⟩ + Σ_j w_j at the chunk's end
        dl    = the reverse in-chunk cumsum of dcum;  da = Σ dt_j·dl_j
    """
    io_dtype = x.dtype
    parts = tensor_cores and io_dtype == torch.bfloat16
    mm = einsum_3xtf32 if tf32x3 else torch.einsum

    def mp(eq, f, v):  # a product with its f32 side f and its bf16 side v
        if not parts:
            return mm(eq, f, v)
        lhs, out = eq.split("->")
        fs, vs = lhs.split(",")
        return einsum_3xbf16(f"{fs},{vs}->{out}", f, v)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
        b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (b, c))
    q = chunk
    xc = x.reshape(bsz, nc, q, h, p).float()
    dyc = dy.reshape(bsz, nc, q, h, p).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b.reshape(bsz, nc, q, g, n).float()
    cc = c.reshape(bsz, nc, q, g, n).float()
    bh = bc.repeat_interleave(rep, dim=3)
    ch = cc.repeat_interleave(rep, dim=3)
    u = xc * dtc[..., None]

    # the forward's pieces: cumsums, C·Bᵀ per group, decay, entry states
    cum = torch.cumsum(dtc * a, dim=2)                  # [B,nc,Q,H]
    cum_end = cum[:, :, -1]                             # [B,nc,H]
    cum_h = cum.permute(0, 1, 3, 2)                     # [B,nc,H,Q]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    below = causal.tril(-1)
    e = torch.where(causal, torch.exp(torch.clamp(
        cum_h[..., :, None] - cum_h[..., None, :], max=0.0)), 0.0)
    m = torch.einsum("bcign,bcjgn->bcgij", cc, bc).repeat_interleave(
        rep, dim=2)                                     # [B,nc,H,Q,Q]
    w_end = torch.exp(cum_end[:, :, None, :] - cum)     # [B,nc,Q,H]
    s_chunk = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", bh, u, w_end)
    state = (torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    entry = []
    for ci in range(nc):
        entry.append(state)
        state = torch.exp(cum_end[:, ci])[:, :, None, None] * state \
            + s_chunk[:, ci]
    s_in = torch.stack(entry, dim=1)                    # [B,nc,H,P,N]

    # reverse state pass: the cotangent of the state leaving each chunk
    ec = torch.exp(cum)                                 # [B,nc,Q,H]
    agg = mp("bcqhp,bcqhn->bchpn", ec[..., None] * dyc, ch)
    shat = (torch.zeros_like(state) if dstate is None else dstate.float())
    hats = [None] * nc
    for ci in reversed(range(nc)):
        hats[ci] = shat
        shat = torch.exp(cum_end[:, ci])[:, :, None, None] * shat \
            + agg[:, ci]
    hat = torch.stack(hats, dim=1)                      # [B,nc,H,P,N]

    # per (chunk, head): dMʰ, the state terms of dC and dB, du, dx, the
    # direct ddt, dcum
    if parts:  # dy·xᵀ, then dt_j and E
        dmh = e * (dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
                   * torch.einsum("bcihp,bcjhp->bchij", dyc, xc))
    else:
        dmh = e * mm("bcihp,bcjhp->bchij", dyc, u)
    gm = torch.where(below, m * dmh, 0.0)
    dcum = gm.sum(-1) - gm.sum(-2)                      # [B,nc,H,Q]
    dc_h = ec[..., None] * mp("bchpn,bcihp->bcihn", s_in, dyc)
    db_h = (w_end * dtc)[..., None] * mp("bchpn,bcjhp->bcjhn", hat, xc)
    dcum = dcum + (ch * dc_h).sum(-1).permute(0, 1, 3, 2)
    du_state = w_end[..., None] * mp("bchpn,bcjhn->bcjhp", hat, bh)
    du = mp("bchij,bcihp->bcjhp", m * e, dyc) + du_state
    w = (u * du_state).sum(-1).permute(0, 1, 3, 2)      # [B,nc,H,Q]
    dcum = dcum - w
    dcum[..., -1] += torch.exp(cum_end) * (hat * s_in).sum((-1, -2)) \
        + w.sum(-1)
    dl = dcum.flip(-1).cumsum(-1).flip(-1).permute(0, 1, 3, 2)  # [B,nc,Q,H]
    dx = du * dtc[..., None]
    ddt = (xc * du).sum(-1) + a * dl
    da = (dtc * dl).sum((0, 1, 2))

    # per (chunk, group): dM summed over the group's heads, dC and dB
    dm = dmh.reshape(bsz, nc, g, rep, q, q).sum(3)
    dc = mp("bcgij,bcjgn->bcign", dm, bc) \
        + dc_h.reshape(bsz, nc, q, g, rep, n).sum(4)
    db = mp("bcgij,bcign->bcjgn", dm, cc) \
        + db_h.reshape(bsz, nc, q, g, rep, n).sum(4)

    def cut(t_):
        return t_.reshape(bsz, nc * q, *t_.shape[3:])[:, :s]
    return (cut(dx).to(io_dtype), cut(ddt), da, cut(db).to(io_dtype),
            cut(dc).to(io_dtype), None if init_state is None else shat)


def ssd_bwd_ref_segments(x, dt, a, b, c, dy, dstate, *, segment: int,
                         chunk: int = 128, init_state=None):
    """:func:`ssd_bwd_ref` over segments of ``segment`` tokens (a multiple
    of ``chunk``), for sequences whose plain algebra does not fit the
    device at once: the forward's state carried into each segment by
    :func:`ssd_ref`, then the segments' backwards from the last, the
    state's cotangent carried back into the one before; ``da`` summed over
    the segments from the last.  The same ``(dx, ddt, da, db, dc, dinit)``
    as one :func:`ssd_bwd_ref` over the whole sequence, to the order of
    the sums across segments."""
    if segment % chunk:
        raise ValueError(f"segment {segment} is not a multiple of the "
                         f"chunk {chunk}")
    starts = range(0, x.shape[1], segment)

    def part(t, i):
        return t[:, i:i + segment].contiguous()
    entry, st = [], init_state
    for i in starts:
        entry.append(st)
        st = ssd_ref(part(x, i), part(dt, i), a, part(b, i), part(c, i),
                     chunk=chunk, init_state=st)[1]
    parts, da, carry = [], None, dstate
    for i, st in reversed(list(zip(starts, entry))):
        dx, ddt, da_i, db, dc, carry = ssd_bwd_ref(
            part(x, i), part(dt, i), a, part(b, i), part(c, i), part(dy, i),
            carry, chunk=chunk, init_state=st)
        parts.append((dx, ddt, db, dc))
        da = da_i if da is None else da + da_i
    dx, ddt, db, dc = (torch.cat(ts[::-1], dim=1) for ts in zip(*parts))
    return dx, ddt, da, db, dc, carry
