"""The bf16 backward's tiled sum order and its schedule, on the CPU.

K3's bf16 backward adds dQ over key tiles of 128 keys in key-tile order
and dK/dV over the heads of a KV group in head order, each step waiting
for the one before it through a turn counter in its scratch.  Its plain
mirror of that order, ``attention_bwd_tiled_ref``, is held to the JAX
reference's gradient of ``layers.attention`` in bf16
(``src/repro/models/layers.py:225``, what the reference's bf16 train step
takes) on ``test_torch_train_bf16_mirrors.py``'s eight shapes, within
``BWD_REF_ULPS`` bf16 ulps of each gradient's largest |entry|, and to
``attention_bwd_ref`` within 1 ulp; rows with no live key and keys with no
live query get exact zeros from both mirrors.  The schedule: the scratch
sizes (``ops.bwd_bf16_scratch``), and, mirrored here in plain Python, the
ticket order (a bijection onto the work items) and the tiles that meet (a
superset of the tile pairs that hold a live pair), and that every wait is
on a block with a smaller ticket (so that a block waits only on blocks
that have started), at GQA 1, 3, 4 and 8, causal and not.

    PYTHONPATH=src python -m pytest -q tests/test_torch_attention_bwd_tiles.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_bwd_tiled_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     live_mask)
from test_torch_train_bf16 import BF16, ulps_of_largest

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

BWD_REF_ULPS = 2

SHAPES = [
    (2, 128, 128, 4, 2, 64, True, None), (1, 256, 256, 2, 2, 32, True, 64),
    (2, 100, 200, 4, 1, 16, False, None), (1, 1, 384, 8, 4, 64, True, None),
    (2, 100, 100, 8, 1, 8, True, None), (1, 150, 150, 6, 2, 24, True, 50),
    (1, 130, 130, 8, 2, 120, True, None),
    (1, 100, 180, 4, 4, 120, False, None)]


# The kernel's schedule in plain Python: its ticket order, the tiles it
# takes to meet, and its waits.

def _work(ticket: int, b: int, hq: int, hk: int) -> tuple:
    """The work item ``(batch, query head, key tile)`` of the bf16
    backward's block that took ``ticket``: tickets run over (key tile,
    batch, KV head, head of the group) in that order, so that key tile j −
    1 of a head comes before key tile j (about a wave of blocks before it)
    and head r − 1 of a group before head r (the kernel's own mapping)."""
    g = hq // hk
    r, rest = ticket % g, ticket // g
    hkv, rest = rest % hk, rest // hk
    return rest % b, hkv * g + r, rest // b


def _ticket(batch: int, head: int, key_tile: int, b: int, hq: int,
                    hk: int) -> int:
    """The ticket of work item ``(batch, head, key_tile)``: the inverse of
    :func:`_work`."""
    g = hq // hk
    return ((key_tile * b + batch) * hk + head // g) * g + head % g


def _tiles_meet(q_pos, k_pos, causal=True, window=None):
    """``[I, J]`` bool: which query tiles of ``ops.BWD_QUERY_TILE`` rows and
    key tiles of ``ops.BWD_KEY_TILE`` keys the bf16 backward takes to meet,
    from each query tile's position range and each key tile's range of
    live keys (the kernel's test, ``tiles_meet``): a superset of the tile
    pairs that hold a live pair.  Positions int, 1-d."""
    q_pos, k_pos = (torch.as_tensor(x).long() for x in (q_pos, k_pos))
    s, t = len(q_pos), len(k_pos)
    i, j = ops._bwd_tiles(s, t)
    qp = torch.nn.functional.pad(q_pos, (0, i * ops.BWD_QUERY_TILE - s),
                                 value=int(q_pos[-1]))
    qp = qp.view(i, ops.BWD_QUERY_TILE)
    kp = torch.nn.functional.pad(k_pos, (0, j * ops.BWD_KEY_TILE - t),
                                 value=-1)
    kp = kp.view(j, ops.BWD_KEY_TILE)
    big = 2 ** 40
    k_lo = torch.where(kp >= 0, kp, big).amin(1)
    k_hi = torch.where(kp >= 0, kp, -big).amax(1)
    meet = (k_lo <= k_hi)[None, :].expand(i, j).clone()
    if causal:
        meet &= k_lo[None, :] <= qp.amax(1)[:, None]
    if window is not None:
        meet &= k_hi[None, :] > qp.amin(1)[:, None] - window
    return meet


def _waits(b: int, hq: int, hk: int, q_pos, k_pos, causal=True,
                   window=None) -> list[tuple[int, int]]:
    """Every wait of the bf16 backward as ``(ticket, ticket waited
    for)``: the block of key tile kt waits, for each query tile it meets,
    on the block of the key tile before it among those that meet the
    query tile (the same head); with grouped heads, head r of a group on
    head r − 1 for the same key tile."""
    meet = _tiles_meet(q_pos, k_pos, causal, window)
    g = hq // hk
    waits = []
    for bi in range(b):
        for h in range(hq):
            for row in meet.tolist():
                kts = [kt for kt, m in enumerate(row) if m]
                waits += [(_ticket(bi, h, kt, b, hq, hk),
                           _ticket(bi, h, prev, b, hq, hk))
                          for prev, kt in zip(kts, kts[1:])]
            if h % g:
                waits += [(_ticket(bi, h, kt, b, hq, hk),
                           _ticket(bi, h - 1, kt, b, hq, hk))
                          for kt in range(meet.shape[1])]
    return waits


def _bf16_pair(x):
    """f32 numpy → (jax bf16, torch bf16) of the same numbers."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


def _inputs(b, s, t, hq, hk, d, seed):
    rng = np.random.default_rng(seed)
    return [_bf16_pair(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, s, hq, d), (b, t, hk, d), (b, t, hk, d),
                          (b, s, hq, d))]


def _mirrors(q, k, v, do, pos, **kw):
    out, lse = attention_ref(q, k, v, **pos), attention_lse_ref(q, k, **pos)
    return (attention_bwd_tiled_ref(q, k, v, out, do, lse, **pos, **kw),
            attention_bwd_ref(q, k, v, out, do, lse, **pos))


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win", SHAPES)
def test_tiled_mirror_matches_jax_grad(b, s, t, hq, hk, d, causal, win):
    (jq, q), (jk, k), (jv, v), (jdo, do) = _inputs(b, s, t, hq, hk, d,
                                                   s + t)
    q_pos = np.arange(s, dtype=np.int32)
    k_pos = np.arange(t, dtype=np.int32)

    def f(q_, k_, v_):
        out = JL.attention(q_, k_, v_, q_pos=jnp.asarray(q_pos),
                           k_pos=jnp.asarray(k_pos), causal=causal,
                           window=win)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))
    exp = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)
    pos = dict(q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
               causal=causal, window=win)
    got, _ = _mirrors(q, k, v, do, pos)
    for g, e in zip(got, exp):
        assert g.dtype == BF16 and tuple(g.shape) == e.shape
        assert ulps_of_largest(g.float().numpy(),
                               e.astype(jnp.float32)) <= BWD_REF_ULPS


@pytest.mark.parametrize("key_tile", [128, 32])
@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win",
                         SHAPES + [(1, 300, 300, 8, 1, 32, True, None)])
def test_tiled_mirror_matches_attention_bwd_ref(b, s, t, hq, hk, d, causal,
                                                win, key_tile):
    """The two mirrors differ only in the order of their f32 sums (and so
    each gradient in its last bits); also with key tiles of 32, more
    shares a row."""
    q, k, v, do = (x for _, x in _inputs(b, s, t, hq, hk, d, 7 + s))
    pos = dict(q_pos=torch.arange(t - s, t, dtype=torch.int32),
               k_pos=torch.arange(t, dtype=torch.int32), causal=causal,
               window=win)
    tiled, whole = _mirrors(q, k, v, do, pos, key_tile=key_tile)
    for g, e in zip(tiled, whole):
        assert g.dtype == BF16 and g.shape == e.shape
        assert ulps_of_largest(g.float().numpy(), e.float().numpy()) <= 1


def _holes(t, lo, hi):
    k_pos = torch.arange(t, dtype=torch.int32)
    k_pos[lo:hi] = -1
    return k_pos


@pytest.mark.parametrize("hq,hk", [(4, 1), (4, 4)])
def test_dead_rows_and_keys_are_exact_zeros(hq, hk):
    """A block of empty slots (−1) wider than a key tile, and a window:
    the queries at positions 164..299 see only empty slots (no live key),
    and slots 100..299 no query; dq there and dk, dv there are exactly 0
    in both mirrors, and the tiles the kernel meets leave query tile 3
    (positions 192..255) to no key tile."""
    b, s, t, d, win = 2, 512, 512, 32, 64
    q, k, v, do = (x for _, x in _inputs(b, s, t, hq, hk, d, 3))
    k_pos = _holes(t, 100, 300)
    pos = dict(q_pos=torch.arange(s, dtype=torch.int32), k_pos=k_pos,
               causal=True, window=win)
    assert not live_mask(pos["q_pos"], k_pos, True, win)[164:300].any()
    for dq, dk, dv in _mirrors(q, k, v, do, pos):
        assert (dq[:, 164:300] == 0).all()
        assert (dk[:, 100:300] == 0).all() and (dv[:, 100:300] == 0).all()
        assert (dq[:, :164] != 0).any() and (dk[:, :100] != 0).any()
    meet = _tiles_meet(pos["q_pos"], k_pos, True, win)
    assert not meet[3].any() and not meet[:, 1].any()


@pytest.mark.parametrize("b,s,t,hq,hk,d", [
    (4, 512, 512, 9, 3, 64), (4, 512, 512, 32, 8, 120),
    (4, 1500, 1500, 20, 20, 64), (4, 512, 1500, 20, 20, 64),
    (1, 3, 70, 6, 1, 32), (1, 100, 120, 3, 1, 16)])
def test_scratch_sizes(b, s, t, hq, hk, d):
    """The ticket and a turn counter per (batch, query head, query tile),
    with grouped heads one per (batch, KV head, key tile), then 2 ints a
    query tile and 3 a key tile; f32 dQ sums for every row and, with
    grouped heads, dK and dV sums per KV head."""
    i, j = -(-s // 64), -(-t // 128)
    n = ops.bwd_bf16_scratch(b, s, t, hq, hk, d)
    assert n == {"delta": b * hq * s, "dq_acc": b * s * hq * d,
                 "dkv_acc": 2 * b * t * hk * d if hq != hk else 0,
                 "ws": 1 + b * hq * i + (b * hk * j if hq != hk else 0)
                 + 2 * i + 3 * j}


@pytest.mark.parametrize("hq,hk", [(8, 8), (9, 3), (32, 8), (8, 1)])
def test_ticket_order_is_a_bijection(hq, hk):
    b, j = 3, 6
    items = [_work(n, b, hq, hk) for n in range(b * hq * j)]
    assert sorted(items) == [(bi, h, kt) for bi in range(b)
                             for h in range(hq) for kt in range(j)]
    assert all(_ticket(*w, b, hq, hk) == n
               for n, w in enumerate(items))


@pytest.mark.parametrize("causal,win,holes", [
    (True, None, None), (False, None, None), (True, 100, None),
    (True, 64, (100, 300)), (False, None, (130, 400))])
@pytest.mark.parametrize("s,t", [(512, 512), (200, 700), (1, 300)])
def test_tiles_meet_every_live_pair(s, t, causal, win, holes):
    q_pos = torch.arange(t - s, t, dtype=torch.int32)
    k_pos = _holes(t, *holes) if holes else torch.arange(t,
                                                         dtype=torch.int32)
    meet = _tiles_meet(q_pos, k_pos, causal, win)
    live = live_mask(q_pos, k_pos, causal, win)
    i, j = meet.shape
    for a in range(i):
        for c in range(j):
            if live[64 * a:64 * a + 64, 128 * c:128 * c + 128].any():
                assert meet[a, c]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hk", [(4, 4), (9, 3), (8, 2), (8, 1)])
def test_every_wait_is_on_a_smaller_ticket(hq, hk, causal):
    """Each block waits, for each query tile it meets, on the block of the
    key tile before it among those that meet the query tile, and, with
    grouped heads, on the block of the previous head of its group: always
    a smaller ticket, so every block waited for has started."""
    b, t = 2, 1100
    pos = torch.arange(t, dtype=torch.int32)
    waits = _waits(b, hq, hk, pos, pos, causal, 300)
    assert waits and all(w > on for w, on in waits)
    g, j = hq // hk, -(-t // 128)
    assert sum(1 for w, on in waits if w - on == 1 and g > 1) \
        == b * (hq - hk) * j
