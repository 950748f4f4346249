"""Public API: the chunked SSD scan in the model layout.

``ssd`` takes x ``[B,S,H,P]``, dt ``[B,S,H]``, a ``[H]``, b/c
``[B,S,G,N]`` and an optional initial state ``[B,H,P,N]``: CPU tensors go
to the plain version in :mod:`.ref`, CUDA tensors launch
``csrc/ssd_scan.cu`` or raise.  Head ``h`` reads group ``h // (H/G)`` of
b/c in place; nothing is repeated or transposed in memory.  One call runs
the source's four launches (scores per group, chunk-parallel intra-chunk
products and chunk states, the state pass over chunks, the inter-chunk
term) through scratch the wrapper allocates.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _lib
from .ref import ssd_ref

#: Longest chunk the kernel takes (the model uses 16-128).
MAX_CHUNK = 128

#: Largest grid y and z extent of a launch.
MAX_GRID_YZ = 65_535


def _load():
    lib = _lib.load("ssd_scan")
    lib.ssd_scan_scratch_floats.restype = ctypes.c_size_t
    lib.ssd_scan_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_scan.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return lib


def ssd_cuda(x, dt, a, b, c, *, chunk: int = 128, init_state=None):
    """Launch the kernel; every tensor contiguous f32 on one CUDA device.
    Returns ``(y [B,S,H,P], state [B,H,P,N])``."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    checks = [("x", x, (bsz, s, h, p)), ("dt", dt, (bsz, s, h)),
              ("a", a, (h,)), ("b", b, (bsz, s, g, n)),
              ("c", c, (bsz, s, g, n))]
    if init_state is not None:
        checks.append(("init_state", init_state, (bsz, h, p, n)))
    for name, t, shape in checks:
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"ssd_scan: {name} must be a contiguous float32 tensor of "
                f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in 1..{MAX_CHUNK}")
    if g == 0 or h % g:
        raise ValueError(f"ssd_scan: {h} heads over {g} groups")
    if x.numel() == 0 or b.numel() == 0:
        raise ValueError("ssd_scan: empty input")
    if -(-s // chunk) * h > MAX_GRID_YZ or bsz > MAX_GRID_YZ:
        raise ValueError(f"ssd_scan: {-(-s // chunk)} chunks x {h} heads or "
                         f"batch {bsz} exceed a grid's {MAX_GRID_YZ}")
    lib = _load()
    y = torch.empty_like(x)
    state = torch.empty(bsz, h, p, n, dtype=torch.float32, device=dev)
    # C.B^T per group, cumsums, chunk states (then entry states)
    scratch = torch.empty(lib.ssd_scan_scratch_floats(bsz, s, h, p, g, n,
                                                      chunk),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib.check(lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), 0 if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), scratch.data_ptr(), bsz, s, h,
            p, g, n, chunk, stream), "ssd_scan")
    _lib.count("ssd_scan")
    return y, state


def ssd(x, dt, a, b, c, *, chunk: int = 128, init_state=None):
    """Model layout → ``(y [B,S,H,P], final state [B,H,P,N] f32)``; the
    kernel for CUDA tensors.

    The kernel has no backward yet.  On CUDA, a call that would need a
    gradient (grad mode on and any input requiring grad) raises
    ``NotImplementedError`` rather than return an output cut off from the
    graph; on the CPU, autograd runs through the plain version."""
    if x.device.type != "cuda":
        return ssd_ref(x, dt, a, b, c, chunk=chunk, init_state=init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, init_state)):
        raise NotImplementedError(
            "ssd_scan: the CUDA kernel has no backward yet; train mamba2 "
            "on the CPU (device='cpu') or call under torch.no_grad()")
    return ssd_cuda(x, dt, a, b, c, chunk=chunk, init_state=init_state)
