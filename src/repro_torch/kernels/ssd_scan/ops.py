"""Public API: the chunked SSD scan in the model layout.

``ssd`` takes x ``[B,S,H,P]``, dt ``[B,S,H]``, a ``[H]``, b/c
``[B,S,G,N]`` and an optional initial state ``[B,H,P,N]``: CPU tensors go
to the plain version in :mod:`.ref`, CUDA tensors launch
``csrc/ssd_scan.cu`` or raise.  Head ``h`` reads group ``h // (H/G)`` of
b/c in place; nothing is repeated or transposed in memory.  One call runs
the source's four launches (scores per group, chunk-parallel intra-chunk
products and chunk states, the state pass over chunks, the inter-chunk
term) through scratch the wrapper allocates.

x, b and c may be bf16 (all three; dt, a and the state stay f32): the
source's bf16 entry point ``ssd_scan_bf16`` runs its products on tensor
cores (C·Bᵀ in bf16, the other three as TF32 with the f32 operand split
in two and the bf16 one whole) and rounds y to bf16 once, from an f32 sum
of the intra- and inter-chunk terms.  It is counted under
``ssd_scan_bf16``; ``ssd_scan`` counts f32 calls only.

A call that needs a gradient goes through :class:`SSDScan`: its forward
keeps the kernel's scratch (C·Bᵀ per group, the cumsums and each chunk's
entry state), and its backward launches the source's backward entry
point of the inputs' type on it: ``ssd_scan_backward`` (seven launches,
every product 3xTF32 on tensor cores; counted under ``ssd_scan_bwd``) or
``ssd_scan_backward_bf16`` (seven launches, x, b, c, dy and dx, db, dc in
bf16; on Hopper's ``wgmma`` from TMA rings with every f32 side as three
exact bf16 parts where TMA takes the shape (p and n multiples of 8, the
chunk of 4, p ≤ 64, n ≤ 128), else dy·xᵀ on bf16 ``mma.sync`` and the
other products with the f32 side split in two TF32 parts;
``ssd_scan_bf16_bwd``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _lib
from .ref import ssd_ref

#: What ``analysis/kernel_audit.py`` (and, on the card, ``chip_smoke.py``
#: in the SASS) holds ``csrc/ssd_scan.cu`` to: no atomics; sums over
#: heads, chunks and tiles run in a fixed order.
AUDIT = {"float_atomics": 0, "int_atomics": {}, "one_block_per": {}}

#: Longest chunk the kernel takes (the model uses 16-128).
MAX_CHUNK = 128

#: Largest grid y and z extent of a launch.  The source's grids run every
#: axis along x, so neither chunks x heads nor the batch is held to it.
MAX_GRID_YZ = 65_535


def _load():
    lib = _lib.load("ssd_scan")
    lib.ssd_scan_scratch_floats.restype = ctypes.c_size_t
    lib.ssd_scan_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_scan.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.ssd_scan_bf16.restype = ctypes.c_int
    lib.ssd_scan_bf16.argtypes = lib.ssd_scan.argtypes
    lib.ssd_scan_backward_scratch_floats.restype = ctypes.c_size_t
    lib.ssd_scan_backward_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.ssd_scan_backward.restype = ctypes.c_int
    lib.ssd_scan_backward.argtypes = [ctypes.c_void_p] * 15 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan_backward_bf16.restype = ctypes.c_int
    lib.ssd_scan_backward_bf16.argtypes = lib.ssd_scan_backward.argtypes
    return lib


def _check(x, dt, a, b, c, chunk, named=()):
    """The kernel's input checks: x, b and c contiguous tensors of one type
    (f32 or bf16), dt, a (and each ``(name, tensor, shape)`` of ``named``
    that is not None) contiguous f32, each of its shape on x's device."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_scan: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    checks = [("x", x, (bsz, s, h, p), x.dtype),
              ("dt", dt, (bsz, s, h), torch.float32),
              ("a", a, (h,), torch.float32),
              ("b", b, (bsz, s, g, n), x.dtype),
              ("c", c, (bsz, s, g, n), x.dtype)]
    checks += [(name, t, shape, torch.float32) for name, t, shape in named
               if t is not None]
    for name, t, shape, dtype in checks:
        if t.device != dev or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"ssd_scan: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in 1..{MAX_CHUNK}")
    if g == 0 or h % g:
        raise ValueError(f"ssd_scan: {h} heads over {g} groups")
    if x.numel() == 0 or b.numel() == 0:
        raise ValueError("ssd_scan: empty input")


def ssd_fwd_cuda(x, dt, a, b, c, *, chunk: int = 128, init_state=None):
    """Launch the kernel; every tensor contiguous on one CUDA device, x, b
    and c f32 or bf16, the rest f32.  Returns ``(y [B,S,H,P] in x's type,
    state [B,H,P,N] f32, saved)``: ``saved`` is the kernel's f32 scratch
    (the same layout in either type), which :func:`ssd_bwd_cuda` reads."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    _check(x, dt, a, b, c, chunk,
           [("init_state", init_state, (bsz, h, p, n))])
    lib = _load()
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty_like(x)
    state = torch.empty(bsz, h, p, n, dtype=torch.float32, device=dev)
    # C.B^T per group, cumsums, chunk states (then entry states)
    scratch = torch.empty(lib.ssd_scan_scratch_floats(bsz, s, h, p, g, n,
                                                      chunk),
                          dtype=torch.float32, device=dev)
    args = [x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), 0 if init_state is None else init_state.data_ptr(),
            y.data_ptr()]
    entry = "ssd_scan_bf16" if bf16 else "ssd_scan"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib.check(getattr(lib, entry)(
            *args, state.data_ptr(), scratch.data_ptr(), bsz, s, h, p, g, n,
            chunk, stream), entry)
    _lib.count(entry)
    return y, state, scratch


def ssd_cuda(x, dt, a, b, c, *, chunk: int = 128, init_state=None):
    """:func:`ssd_fwd_cuda` without the scratch: ``(y, state)``."""
    return ssd_fwd_cuda(x, dt, a, b, c, chunk=chunk,
                        init_state=init_state)[:2]


def ssd_bwd_cuda(x, dt, a, b, c, dy, dstate, *, saved, chunk: int = 128,
                 init_state=None):
    """Launch the backward: from the forward's inputs, its ``saved``
    scratch (:func:`ssd_fwd_cuda` on the same inputs) and the cotangents
    ``dy [B,S,H,P]`` (x's type) and ``dstate [B,H,P,N]`` (f32; None: zero),
    returns ``(dx, ddt, da, db, dc, dinit)``, dx, db and dc in x's type,
    the rest f32; ``dinit`` is None without an ``init_state``.  Every
    tensor contiguous on one CUDA device; x, b, c and dy f32 or bf16, the
    rest f32."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    _check(x, dt, a, b, c, chunk,
           [("init_state", init_state, (bsz, h, p, n)),
            ("dstate", dstate, (bsz, h, p, n))])
    if dy.device != dev or dy.dtype != x.dtype \
            or tuple(dy.shape) != (bsz, s, h, p) or not dy.is_contiguous():
        raise ValueError(
            f"ssd_scan: dy must be a contiguous {x.dtype} tensor of shape "
            f"{(bsz, s, h, p)} on {dev}, got {dy.dtype} {tuple(dy.shape)} "
            f"on {dy.device}")
    lib = _load()
    want = lib.ssd_scan_scratch_floats(bsz, s, h, p, g, n, chunk)
    if saved.device != dev or saved.dtype != torch.float32 \
            or saved.numel() != want or not saved.is_contiguous():
        raise ValueError(f"ssd_scan backward: saved must be the forward's "
                         f"scratch, {want} float32 on {dev}")
    dx, ddt, da, db, dc = (torch.empty_like(t) for t in (x, dt, a, b, c))
    dinit = None if init_state is None else torch.empty_like(init_state)
    # aggregates then Ŝ per chunk, the group's dM, the tiles' sums for
    # dcum and ddt, the shares of da
    scratch = torch.empty(lib.ssd_scan_backward_scratch_floats(
        bsz, s, h, p, g, n, chunk), dtype=torch.float32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    bf16 = x.dtype == torch.bfloat16
    entry = "ssd_scan_backward_bf16" if bf16 else "ssd_scan_backward"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib.check(getattr(lib, entry)(
            *map(ptr, (x, dt, a, b, c, dy, dstate, saved, dx, ddt, da, db,
                       dc, dinit, scratch)), bsz, s, h, p, g, n, chunk,
            stream), entry)
    _lib.count("ssd_scan_bf16_bwd" if bf16 else "ssd_scan_bwd")
    return dx, ddt, da, db, dc, dinit


class SSDScan(torch.autograd.Function):
    """K4 with a gradient: the forward launches the kernel and keeps its
    scratch, the backward launches the backward entry point on it.  The
    final state's cotangent may be absent (the train path discards the
    state); ``chunk`` takes no gradient."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, init_state, chunk):
        y, state, saved = ssd_fwd_cuda(x, dt, a, b, c, chunk=chunk,
                                       init_state=init_state)
        ctx.save_for_backward(x, dt, a, b, c, init_state, saved)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, init_state, saved = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_bwd_cuda(
            x, dt, a, b, c, dy,
            None if dstate is None else dstate.contiguous(), saved=saved,
            chunk=ctx.chunk, init_state=init_state)
        return (*grads, None)


def ssd(x, dt, a, b, c, *, chunk: int = 128, init_state=None):
    """Model layout → ``(y [B,S,H,P] in x's type, final state [B,H,P,N]
    f32)``; the kernel for CUDA tensors, through :class:`SSDScan` when a
    gradient is needed (grad mode on and any input requiring grad).  On
    the CPU, autograd runs through the plain version."""
    if x.device.type != "cuda":
        return ssd_ref(x, dt, a, b, c, chunk=chunk, init_state=init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, init_state)):
        return SSDScan.apply(x, dt, a, b, c, init_state, chunk)
    return ssd_cuda(x, dt, a, b, c, chunk=chunk, init_state=init_state)
