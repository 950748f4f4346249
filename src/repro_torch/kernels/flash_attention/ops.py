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
prefill.  The f32 decode's split length is the source's own
(``flash_attention_split_keys``); the wrapper reads it to size the
partials' scratch.  The bf16 decode is one launch without scratch, a
cluster of blocks per KV head, its splits from :func:`decode_splits`.

A caller that knows ``k_pos`` is non-decreasing (a prefill's or a train
step's own ``arange``) says so with ``sorted_keys=True``; past
:data:`SEARCH_MIN_KEYS` keys (:func:`bounded_walk`) the prefill entry
points then walk only the key tiles that can be live for each block (the
kernels' ``live_tile_range``, the range :func:`.ref.live_tile_range`
gives) instead of every tile from key 0, with the same output bit for
bit.  Nothing checks the promise on the device: a ring cache's table (a
decode's) is never marked, and keeps the full walk.

Every entry point takes each head dim that is a multiple of 8 from 8 to
128 (:func:`padded_head_dim`): the kernels run at the next tile width the
source builds and read q, k, v and the cache in place, so the wrapper
copies none of them.

The source takes f32 and bf16.  A bf16 call (q, k and v all bf16)
launches the bf16 entry points (``flash_attention_prefill_bf16``, on
Hopper's tensor cores by ``wgmma`` over TMA copies, and
``flash_attention_decode_bf16``, by ``mma.sync`` in one cluster launch),
counted under
``flash_attention_bf16`` and ``flash_attention_bf16_prefill`` /
``flash_attention_bf16_decode``; the f32 keys count f32 launches only.
Mixed types raise, on every device: nothing is cast quietly.

When a gradient is needed (grad mode on and q, k or v requiring grad),
:func:`gqa_attention` goes through :class:`FlashAttention`, an autograd
function: its forward takes the prefill entry point of the inputs' type
whatever the shape, which also writes each row's log-sum-exp, and its
backward launches the source's backward entry point of that type
(:func:`flash_attention_bwd_cuda`, counted as one launch of
``flash_attention_bwd``, f32: three kernels, four with grouped heads, its
products on tensor cores in 3xTF32; or ``flash_attention_bf16_bwd``, bf16:
two kernels, the second a Hopper kernel on ``wgmma`` over key tiles that
adds dQ and the group's dK/dV in a fixed order through turn counters in
its scratch, :func:`bwd_bf16_scratch`).  On the CPU, autograd runs through
the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _lib
from .ref import attention_ref

#: What ``analysis/kernel_audit.py`` (and, on the card, ``chip_smoke.py``
#: in the SASS) holds ``csrc/flash_attention.cu`` to: no float atomics
#: (the backwards add dQ and a group's dK/dV in a fixed order); one
#: integer atomic, the bf16 backward's work ticket.
AUDIT = {"float_atomics": 0,
         "int_atomics": {"flash_bwd_bf16_hopper_kernel": ("atomicAdd",)},
         "one_block_per": {}}

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

#: Most keys a prefill walks from key 0 whatever its table: up to here a
#: block's dead tiles cost less than the search that skips them (on an
#: H100 the bf16 search lost 3-5 % at 512 keys and 1-3 % at 1,024, and
#: won 3-4 % at 2,048; the f32 one within 3 % either way up to 1,024;
#: ``chip_smoke.py --k3-walk``, PERF.md section 6).
SEARCH_MIN_KEYS = 1024


def bounded_walk(t: int, sorted_keys: bool) -> bool:
    """Whether a prefill over ``t`` keys has each block search for its
    live key tiles (``live_tile_range``): only for a table the caller
    knows is sorted, longer than :data:`SEARCH_MIN_KEYS`."""
    return bool(sorted_keys) and t > SEARCH_MIN_KEYS


#: Most query rows a KV head (``S · Hq/Hkv``) sent to the decode entry
#: point, which holds them all in one block.
DECODE_MAX_ROWS = 16


def uses_decode(s: int, hq: int, hk: int) -> bool:
    """Whether ``S`` query rows over ``hq`` query and ``hk`` KV heads take
    the split-key decode entry point.  The rule holds for calls that need
    no gradient; a call that does always takes the prefill."""
    return s * (hq // hk) <= DECODE_MAX_ROWS


#: Most splits of the bf16 decode, the blocks of one cluster (the
#: portable cluster size).
DECODE_MAX_SPLITS = 8

#: Keys of a tile, the unit of a bf16 decode split.
DECODE_TILE = 64

#: Tiles a bf16 decode split streams at most where more splits are
#: allowed: a block walks its tiles one after another, so a long split is
#: a long chain (whisper-large-v3's cross decode, 24 tiles over 80 KV
#: heads, takes 4 splits).
DECODE_SPLIT_TILES = 6


def decode_splits(b: int, t: int, hk: int, sms: int) -> tuple[int, int]:
    """``(n_split, split_keys)`` of the bf16 decode for batch ``b``, ``t``
    cache slots and ``hk`` KV heads on a card of ``sms`` multiprocessors:
    the slots of each (batch, KV head) cut into ``n_split`` contiguous
    splits of ``split_keys`` (a multiple of :data:`DECODE_TILE`), one block
    of a cluster each.  Enough splits for a block a multiprocessor and
    splits of at most :data:`DECODE_SPLIT_TILES` tiles, within
    :data:`DECODE_MAX_SPLITS` and one a tile; the split length then evens
    the tiles out, so that no split is empty by shape.  A pure function of
    the shapes and the card: the order of every sum, and so the bits, are
    the same from run to run."""
    tiles = -(-t // DECODE_TILE)
    want = max(-(-sms // (b * hk)), -(-tiles // DECODE_SPLIT_TILES))
    want = min(DECODE_MAX_SPLITS, tiles, want)
    per = -(-tiles // want)
    return -(-tiles // per), per * DECODE_TILE


_sms: dict[int, int] = {}


def _sm_count(dev) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


#: The types the kernel takes; q, k, v and the output share one.
DTYPES = (torch.float32, torch.bfloat16)

#: The bf16 backward's tiles: keys a block owns (two warpgroups of 64) and
#: query rows a streamed tile holds (``BKT``, ``BQT`` in the source).
BWD_KEY_TILE = 128
BWD_QUERY_TILE = 64


def _bwd_tiles(s: int, t: int) -> tuple[int, int]:
    return -(-s // BWD_QUERY_TILE), -(-t // BWD_KEY_TILE)


def bwd_bf16_scratch(b: int, s: int, t: int, hq: int, hk: int,
                     d: int) -> dict[str, int]:
    """Elements of each scratch buffer of the bf16 backward for q
    ``[b,s,hq,d]`` and k/v ``[b,t,hk,d]``: ``delta`` (f32, each row's
    rowsum(dO∘O)), ``dq_acc`` (f32, dQ summed over the key tiles so far),
    ``dkv_acc`` (f32, dK then dV summed over a group's heads so far; 0 when
    ``hq == hk``, where each block writes its own) and ``ws`` (int32: the
    ticket, a turn counter per (batch, query head, query tile) and, with
    grouped heads, per (batch, KV head, key tile), all zeroed by the D
    launch; then each query tile's position range and each key tile's
    range of live keys and whether all of its keys are live, written by
    it).  A pure function of the shapes; the wrapper allocates exactly
    these with ``torch.empty``."""
    i, j = _bwd_tiles(s, t)
    zeroed = 1 + b * hq * i + (b * hk * j if hq != hk else 0)
    return {"delta": b * hq * s, "dq_acc": b * s * hq * d,
            "dkv_acc": 2 * b * t * hk * d if hq != hk else 0,
            "ws": zeroed + 2 * i + 3 * j}


def _load():
    lib = _lib.load("flash_attention")
    for fn, n_ptr, n_int in ((lib.flash_attention_prefill, 7, 9),
                             (lib.flash_attention_decode, 9, 8),
                             (lib.flash_attention_backward, 13, 8),
                             (lib.flash_attention_prefill_bf16, 7, 9),
                             (lib.flash_attention_decode_bf16, 6, 10),
                             (lib.flash_attention_backward_bf16, 15, 8)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
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


def _forward(q, k, v, q_pos, k_pos, causal, window, lse, sorted_keys):
    """Check and launch a forward entry point; ``lse`` (f32 [B,Hq,S])
    takes the prefill whatever the shape and gets each row's
    log-sum-exp; ``sorted_keys`` bounds the prefill's walk."""
    _check_inputs(q, k, v, q_pos, k_pos, window)
    b, s, hq, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    dev = q.device
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lib = _load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr())
    dims = _dims(q, k, causal, window)
    decode = lse is None and uses_decode(s, hq, hk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if decode and bf16:
            rc = lib.flash_attention_decode_bf16(
                *args, *dims, *decode_splits(b, t, hk, _sm_count(dev)),
                stream)
        elif decode:
            # per (row, query head, split): running max, sum, accumulator
            n = b * s * hq * -(-t // lib.flash_attention_split_keys())
            part = torch.empty(n * (2 + d), dtype=torch.float32, device=dev)
            rc = lib.flash_attention_decode(
                *args, part.data_ptr(), part[n:].data_ptr(),
                part[2 * n:].data_ptr(), *dims, stream)
        else:
            prefill = lib.flash_attention_prefill_bf16 if bf16 \
                else lib.flash_attention_prefill
            rc = prefill(*args, 0 if lse is None else lse.data_ptr(), *dims,
                         int(bounded_walk(t, sorted_keys)), stream)
    kind = "decode" if decode else "prefill"
    _lib.check(rc, f"flash_attention_{kind}{'_bf16' if bf16 else ''}")
    family = "flash_attention_bf16" if bf16 else "flash_attention"
    _lib.count(family)
    _lib.count(f"{family}_{kind}")
    return out


def flash_attention_cuda(q, k, v, *, q_pos, k_pos, causal=True,
                         window=None, sorted_keys=False):
    """Launch the kernel; every tensor contiguous on one CUDA device, q, k
    and v all f32 or all bf16 (positions int32); the output in their
    type.  ``sorted_keys``: ``k_pos`` is non-decreasing (not checked)."""
    return _forward(q, k, v, q_pos, k_pos, causal, window, None,
                    sorted_keys)


def _prefill(q, k, v, *, q_pos, k_pos, causal=True, window=None,
             sorted_keys=False):
    """The prefill entry point whatever the shape, for the backward:
    returns ``(out, lse [B,Hq,S] f32)``, each row's log-sum-exp of scaled
    live scores."""
    b, s, hq, _ = q.shape
    lse = torch.empty(b, hq, s, dtype=torch.float32, device=q.device)
    return _forward(q, k, v, q_pos, k_pos, causal, window, lse,
                    sorted_keys), lse


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, q_pos, k_pos,
                             causal=True, window=None):
    """Launch the backward: from the forward's inputs, its ``out`` and
    ``lse`` (:func:`_prefill`) and ``dout`` [B,S,Hq,D], returns ``(dq
    [B,S,Hq,D], dk [B,T,Hkv,D], dv)`` in the inputs' type; dk and dv summed
    over the query heads of each KV head.  q, k, v, out and dout one type
    (f32 or bf16), ``lse`` f32, positions int32, every tensor contiguous on
    one CUDA device."""
    _check_inputs(q, k, v, q_pos, k_pos, window)
    b, s, hq, d = q.shape
    dev = q.device
    bf16 = q.dtype == torch.bfloat16
    _check((("out", out, q.dtype, tuple(q.shape)),
            ("dout", dout, q.dtype, tuple(q.shape)),
            ("lse", lse, torch.float32, (b, hq, s))), dev)
    t, hk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    lib = _load()
    if bf16:
        n = bwd_bf16_scratch(b, s, t, hq, hk, d)
        f32 = dict(dtype=torch.float32, device=dev)
        delta = torch.empty(n["delta"], **f32)
        ws = torch.empty(n["ws"], dtype=torch.int32, device=dev)
        dq_acc = torch.empty(n["dq_acc"], **f32)
        dkv_acc = torch.empty(n["dkv_acc"], **f32) if n["dkv_acc"] \
            else None
        scratch = (delta.data_ptr(), ws.data_ptr(), dq_acc.data_ptr(),
                   0 if dkv_acc is None else dkv_acc.data_ptr())
        entry = "flash_attention_backward_bf16"
    else:
        delta = torch.empty(b, hq, s, dtype=torch.float32, device=dev)
        # each query head's share of dK and dV (f32), added per group by
        # the kernel
        part = torch.empty(2 * b * t * hq * d, dtype=torch.float32,
                           device=dev) if hq != hk else None
        scratch = (delta.data_ptr(), 0 if part is None else part.data_ptr())
        entry = "flash_attention_backward"
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), *scratch, dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_dims(q, k, causal, window),
            torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(rc, entry)
    _lib.count("flash_attention_bf16_bwd" if bf16 else "flash_attention_bwd")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K3 with a gradient: the forward launches the prefill entry point
    and keeps its log-sum-exp, the backward launches the backward entry
    point, each of the inputs' type (f32 or bf16).  Positions, ``causal``,
    ``window`` and ``sorted_keys`` take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window,
                sorted_keys=False):
        out, lse = _prefill(q, k, v, q_pos=q_pos, k_pos=k_pos,
                            causal=causal, window=window,
                            sorted_keys=sorted_keys)
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
        return dq, dk, dv, None, None, None, None, None


def gqa_attention(q, k, v, *, q_pos, k_pos, causal=True, window=None,
                  sorted_keys=False):
    """q [B,S,Hq,D], k/v [B,T,Hkv,D], q_pos [S] / k_pos [T] int32 →
    [B,S,Hq,D] in q's type; q, k and v share one type (f32 or bf16).  The
    kernel for CUDA tensors, through :class:`FlashAttention` when a
    gradient is needed.  ``sorted_keys``: the caller knows ``k_pos`` is
    non-decreasing, and the prefill walks only the tiles that can be live
    (the same result; ignored by the plain version)."""
    check_types(q, k, v)
    if q.device.type != "cuda":
        return attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos,
                             causal=causal, window=window)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window,
                                    sorted_keys)
    return flash_attention_cuda(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                causal=causal, window=window,
                                sorted_keys=sorted_keys)
