"""Public API: grouped-query attention over explicit positions.

``gqa_attention`` takes the model layout (q ``[B,S,Hq,D]``, k/v
``[B,T,Hkv,D]``) with int32 positions ``q_pos [S]`` / ``k_pos [T]``: CPU
tensors go to the plain version in :mod:`.ref`, CUDA tensors launch
``csrc/flash_attention.cu`` or raise.  Unlike the reference wrapper, K/V
are never repeated to the query heads in memory: the kernel reads KV head
``h // (Hq/Hkv)`` in place.

The source has two entry points, picked from the shapes alone
(:func:`uses_decode`): the split-key decode when the query rows of one KV
head, ``S · Hq/Hkv``, are at most ``DECODE_MAX_ROWS`` (a serving decode
step: S = 1), else the tiled prefill.  The decode's split length is the
source's own (``flash_attention_split_keys``); the wrapper reads it to size
the partials' scratch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _lib
from .ref import attention_ref

#: Head dims the kernel is built for.
HEAD_DIMS = (16, 32, 64, 128)

#: Most query rows a KV head (``S · Hq/Hkv``) sent to the decode entry
#: point, which holds them all in one block.
DECODE_MAX_ROWS = 16


def uses_decode(s: int, hq: int, hk: int) -> bool:
    """Whether ``S`` query rows over ``hq`` query and ``hk`` KV heads take
    the split-key decode entry point."""
    return s * (hq // hk) <= DECODE_MAX_ROWS


def _load():
    lib = _lib.load("flash_attention")
    for fn, n_ptr in ((lib.flash_attention_prefill, 6),
                      (lib.flash_attention_decode, 9)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
    lib.flash_attention_split_keys.restype = ctypes.c_int
    lib.flash_attention_split_keys.argtypes = []
    return lib


def flash_attention_cuda(q, k, v, *, q_pos, k_pos, causal=True,
                         window=None):
    """Launch the kernel; every tensor contiguous on one CUDA device, f32
    (positions int32)."""
    b, s, hq, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    dev = q.device
    for name, x, dtype, shape in (
            ("q", q, torch.float32, (b, s, hq, d)),
            ("k", k, torch.float32, (b, t, hk, d)),
            ("v", v, torch.float32, (b, t, hk, d)),
            ("q_pos", q_pos, torch.int32, (s,)),
            ("k_pos", k_pos, torch.int32, (t,))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"flash_attention: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
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
    out = torch.empty_like(q)
    lib = _load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr())
    dims = (b, s, t, hq, hk, d, int(bool(causal)),
            0 if window is None else int(window))
    decode = uses_decode(s, hq, hk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if decode:
            # per (row, query head, split): running max, sum, accumulator
            n = b * s * hq * -(-t // lib.flash_attention_split_keys())
            part = torch.empty(n * (2 + d), dtype=torch.float32, device=dev)
            rc = lib.flash_attention_decode(
                *args, part.data_ptr(), part[n:].data_ptr(),
                part[2 * n:].data_ptr(), *dims, stream)
        else:
            rc = lib.flash_attention_prefill(*args, *dims, stream)
    entry = "flash_attention_decode" if decode else "flash_attention_prefill"
    _lib.check(rc, entry)
    _lib.count("flash_attention")
    _lib.count(entry)
    return out


def gqa_attention(q, k, v, *, q_pos, k_pos, causal=True, window=None):
    """q [B,S,Hq,D], k/v [B,T,Hkv,D], q_pos [S] / k_pos [T] int32 →
    [B,S,Hq,D]; the kernel for CUDA tensors (f32 only)."""
    attend = flash_attention_cuda if q.device.type == "cuda" \
        else attention_ref
    return attend(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                  window=window)
