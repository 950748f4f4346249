"""Public API: grouped-query attention over explicit positions.

``gqa_attention`` takes the model layout (q ``[B,S,Hq,D]``, k/v
``[B,T,Hkv,D]``) with int32 positions ``q_pos [S]`` / ``k_pos [T]``: CPU
tensors go to the plain version in :mod:`.ref`, CUDA tensors launch
``csrc/flash_attention.cu`` or raise.  Unlike the reference wrapper, K/V
are never repeated to the query heads in memory: the kernel reads KV head
``h // (Hq/Hkv)`` in place.

The source has two forward entry points, picked from the shapes alone
(:func:`uses_decode`) for calls that need no gradient: the split-key
decode when the query rows of one KV head, ``S · Hq/Hkv``, are at most
``DECODE_MAX_ROWS`` (a serving decode step: S = 1), else the tiled
prefill.  The decode's split length is the source's own
(``flash_attention_split_keys``); the wrapper reads it to size the
partials' scratch.

Every entry point takes each head dim that is a multiple of 8 from 8 to
128 (:func:`padded_head_dim`): the kernels run at the next tile width the
source builds and read q, k, v and the cache in place, so the wrapper
copies none of them.

The source takes f32 and bf16.  A bf16 call (q, k and v all bf16)
launches the bf16 entry points (``flash_attention_prefill_bf16``, on
Hopper's tensor cores by ``wgmma`` over TMA copies, and
``flash_attention_decode_bf16``), counted under
``flash_attention_bf16`` and ``flash_attention_bf16_prefill`` /
``flash_attention_bf16_decode``; the f32 keys count f32 launches only.
Mixed types raise, on every device: nothing is cast quietly.

When a gradient is needed (grad mode on and q, k or v requiring grad),
:func:`gqa_attention` goes through :class:`FlashAttention`, an autograd
function: its forward takes the prefill entry point whatever the shape,
which also writes each row's log-sum-exp, and its backward launches the
source's backward entry point (:func:`flash_attention_bwd_cuda`, three
kernels, four with grouped heads, counted as one launch of
``flash_attention_bwd``).  On the CPU,
autograd runs through the plain version.  The backward takes f32 only: a
bf16 call on the card that needs a gradient raises (bf16 training, with a
bf16 backward, is the next item of ROADMAP Queue 1).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _lib
from .ref import attention_ref

#: Tile widths the source builds its kernels for, in head-dim columns.
TILE_WIDTHS = (16, 32, 64, 128)


def padded_head_dim(d: int) -> int:
    """The tile width the kernels run head dim ``d`` at: the smallest of
    :data:`TILE_WIDTHS` that holds it.  The kernels take every multiple of
    8 from 8 to 128 (a row of 8 f32 or bf16 values starts on a 16-byte
    boundary, the unit they copy), read the ``d`` columns in place, keep
    the columns past ``d`` zero in shared memory and never write them; the
    scale is 1/√d.  Any other ``d`` raises ``ValueError``; the C entry
    points apply the same rule (``padded_head_dim`` in the source)."""
    if not (8 <= d <= TILE_WIDTHS[-1] and d % 8 == 0):
        raise ValueError(f"flash_attention: head dim {d} is not a multiple "
                         f"of 8 from 8 to {TILE_WIDTHS[-1]}")
    return next(w for w in TILE_WIDTHS if w >= d)

#: Most query rows a KV head (``S · Hq/Hkv``) sent to the decode entry
#: point, which holds them all in one block.
DECODE_MAX_ROWS = 16


def uses_decode(s: int, hq: int, hk: int) -> bool:
    """Whether ``S`` query rows over ``hq`` query and ``hk`` KV heads take
    the split-key decode entry point.  The rule holds for calls that need
    no gradient; a call that does always takes the prefill."""
    return s * (hq // hk) <= DECODE_MAX_ROWS


#: The types the kernel takes; q, k, v and the output share one.
DTYPES = (torch.float32, torch.bfloat16)


def _load():
    lib = _lib.load("flash_attention")
    for fn, n_ptr in ((lib.flash_attention_prefill, 7),
                      (lib.flash_attention_decode, 9),
                      (lib.flash_attention_backward, 13),
                      (lib.flash_attention_prefill_bf16, 6),
                      (lib.flash_attention_decode_bf16, 9)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
    lib.flash_attention_split_keys.restype = ctypes.c_int
    lib.flash_attention_split_keys.argtypes = []
    return lib


def _check(tensors, dev):
    for name, x, dtype, shape in tensors:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"flash_attention: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


def check_types(q, k, v):
    """Raise unless q, k and v share one type the kernel takes."""
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise ValueError(
            f"flash_attention: q, k and v must share one type of {DTYPES}, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")


def _check_inputs(q, k, v, q_pos, k_pos, window):
    b, s, hq, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    check_types(q, k, v)
    _check((("q", q, q.dtype, (b, s, hq, d)),
            ("k", k, q.dtype, (b, t, hk, d)),
            ("v", v, q.dtype, (b, t, hk, d)),
            ("q_pos", q_pos, torch.int32, (s,)),
            ("k_pos", k_pos, torch.int32, (t,))), q.device)
    padded_head_dim(d)
    if hk == 0 or hq % hk:
        raise ValueError(f"flash_attention: {hq} query heads over {hk} KV "
                         "heads")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be > 0")
    if q.numel() == 0 or t == 0:
        raise ValueError("flash_attention: empty query or key axis")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             "16-byte boundary (the kernel copies 16 bytes "
                             "at a time)")


def _dims(q, k, causal, window):
    b, s, hq, d = q.shape
    return (b, s, k.shape[1], hq, k.shape[2], d, int(bool(causal)),
            0 if window is None else int(window))


def _forward(q, k, v, q_pos, k_pos, causal, window, lse):
    """Check and launch a forward entry point; ``lse`` (f32 [B,Hq,S], f32
    inputs only) takes the prefill whatever the shape and gets each row's
    log-sum-exp."""
    _check_inputs(q, k, v, q_pos, k_pos, window)
    b, s, hq, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    dev = q.device
    bf16 = q.dtype == torch.bfloat16
    if bf16 and lse is not None:
        raise ValueError("flash_attention: the log-sum-exp output (for the "
                         "backward) takes f32 inputs only")
    out = torch.empty_like(q)
    lib = _load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr())
    dims = _dims(q, k, causal, window)
    decode = lse is None and uses_decode(s, hq, hk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if decode:
            # per (row, query head, split): running max, sum, accumulator
            n = b * s * hq * -(-t // lib.flash_attention_split_keys())
            part = torch.empty(n * (2 + d), dtype=torch.float32, device=dev)
            fn = (lib.flash_attention_decode_bf16 if bf16
                  else lib.flash_attention_decode)
            rc = fn(*args, part.data_ptr(), part[n:].data_ptr(),
                    part[2 * n:].data_ptr(), *dims, stream)
        elif bf16:
            rc = lib.flash_attention_prefill_bf16(*args, *dims, stream)
        else:
            rc = lib.flash_attention_prefill(
                *args, 0 if lse is None else lse.data_ptr(), *dims, stream)
    kind = "decode" if decode else "prefill"
    _lib.check(rc, f"flash_attention_{kind}{'_bf16' if bf16 else ''}")
    family = "flash_attention_bf16" if bf16 else "flash_attention"
    _lib.count(family)
    _lib.count(f"{family}_{kind}")
    return out


def flash_attention_cuda(q, k, v, *, q_pos, k_pos, causal=True,
                         window=None):
    """Launch the kernel; every tensor contiguous on one CUDA device, q, k
    and v all f32 or all bf16 (positions int32); the output in their
    type."""
    return _forward(q, k, v, q_pos, k_pos, causal, window, None)


def _prefill(q, k, v, *, q_pos, k_pos, causal=True, window=None):
    """The prefill entry point whatever the shape, for the backward:
    returns ``(out, lse [B,Hq,S] f32)``, each row's log-sum-exp of scaled
    live scores."""
    b, s, hq, _ = q.shape
    lse = torch.empty(b, hq, s, dtype=torch.float32, device=q.device)
    return _forward(q, k, v, q_pos, k_pos, causal, window, lse), lse


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, q_pos, k_pos,
                             causal=True, window=None):
    """Launch the backward: from the forward's inputs, its ``out`` and
    ``lse`` (:func:`_prefill`) and ``dout``
    [B,S,Hq,D], returns f32 ``(dq [B,S,Hq,D], dk [B,T,Hkv,D], dv)``; dk and
    dv summed over the query heads of each KV head.  Every tensor
    contiguous f32 (positions int32) on one CUDA device."""
    _check_inputs(q, k, v, q_pos, k_pos, window)
    if q.dtype != torch.float32:
        raise ValueError("flash_attention backward: f32 inputs only")
    b, s, hq, d = q.shape
    dev = q.device
    _check((("out", out, torch.float32, tuple(q.shape)),
            ("dout", dout, torch.float32, tuple(q.shape)),
            ("lse", lse, torch.float32, (b, hq, s))), dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty(b, hq, s, dtype=torch.float32, device=dev)
    # each query head's share of dK and dV, added per group by the kernel
    part = torch.empty(2 * b * k.shape[1] * hq * d, dtype=torch.float32,
                       device=dev) if hq != k.shape[2] else None
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), delta.data_ptr(),
            0 if part is None else part.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *_dims(q, k, causal, window),
            torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(rc, "flash_attention_backward")
    _lib.count("flash_attention_bwd")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K3 with a gradient: the forward launches the prefill entry point
    and keeps its log-sum-exp, the backward launches the backward entry
    point.  Positions, ``causal`` and ``window`` take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window):
        out, lse = _prefill(q, k, v, q_pos=q_pos, k_pos=k_pos,
                            causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, dout.contiguous(), lse, q_pos=q_pos, k_pos=k_pos,
            causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def gqa_attention(q, k, v, *, q_pos, k_pos, causal=True, window=None):
    """q [B,S,Hq,D], k/v [B,T,Hkv,D], q_pos [S] / k_pos [T] int32 →
    [B,S,Hq,D] in q's type; q, k and v share one type (f32 or bf16).  The
    kernel for CUDA tensors, through :class:`FlashAttention` when a
    gradient is needed (f32 only)."""
    check_types(q, k, v)
    if q.device.type != "cuda":
        return attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos,
                             causal=causal, window=window)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if q.dtype != torch.float32:
            raise NotImplementedError(
                "flash_attention: the backward takes f32 only; a bf16 "
                "backward comes with bf16 training (ROADMAP Queue 1)")
        return FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window)
    return flash_attention_cuda(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                causal=causal, window=window)
