"""Where one block of ``csrc/sketch_insert.cu`` keeps each section of a
sketch, and how many bytes each takes: ``layout()`` in the source, restated
(the card holds the two equal, ``chip_smoke.py`` and
``tests/test_torch_cuda.py``).  No torch import.

A sketch whose sections all fit one block's shared memory
(``MAX_SMEM_BYTES``) runs the shared-memory kernel, with 16-bit row and
index slots.  Any other runs the device-memory variant of the same kernel
body: its slots are 32 bits wide, and the sections that do not fit live in
a device-memory scratch that the wrapper allocates.  :func:`placement`
moves the fewest sections, largest first, so that the chain state the
Stage-2 warp walks on every run (the FIFO ring, the free bitmap, the row
and index slots) stays in shared memory wherever it fits; the staged runs
always do.
"""

from __future__ import annotations

from .._lib import MAX_SMEM_BYTES

#: Sections that may live in device memory, in the layout's order; section
#: ``SECTIONS[i]`` is bit ``1 << i`` of a placement mask (``SEC_*`` in the
#: source).
SECTIONS = ("idx", "t1", "s2", "pos", "ring", "fbits")

# the source's constants, restated: sizeof(SketchArgs), the ring's stages,
# the runs of a stage, the words of a Stage-2 row
ARGS_BYTES = 35 * 8 + 6 * 4
NSTAGE = 2
CHUNK = 192 - 64
ROW_WORDS = 12


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def index_slots(L: int) -> int:
    """Slots of the Stage-2 key index: the least power of two ≥ 2L."""
    return 1 << max(2 * L - 1, 0).bit_length()


def section_bytes(d: int, m: int, L: int, wide: bool) -> dict[str, int]:
    """Bytes of each movable section (``wide``: 32-bit slots)."""
    slot = 4 if wide else 2
    return {"idx": index_slots(L) * 16,          # (lo, hi, row, home)
            "t1": 16 * d * m,                    # Stage 1, an int4 a bucket
            "s2": 4 * ROW_WORDS * L,             # Stage-2 rows
            "pos": slot * L,                     # row -> index slot
            "ring": slot * L,                    # FIFO ring of live rows
            "fbits": 4 * -(-L // 32)}            # free-row bitmap


def _stage_bytes(d: int) -> int:
    # staged runs: 9 fields, a row-shaped record and d buckets; list lengths
    return 4 * (NSTAGE * CHUNK * (9 + ROW_WORDS + d) + NSTAGE)


def bytes_placed(d: int, m: int, L: int, wide: bool = False,
                 place: int = 0) -> tuple[int, int]:
    """``(shared, scratch)`` bytes of one block: ``layout(d, m, L, wide,
    place).total`` and ``.scratch`` in the source, each section starting
    on 16 bytes."""
    sizes = section_bytes(d, m, L, wide)
    shared = _align16(_align16(ARGS_BYTES) + 3 * NSTAGE * 8 + 2 * 4)
    scratch = 0
    for i, name in enumerate(SECTIONS):
        if place >> i & 1:
            scratch = _align16(scratch + sizes[name])
        else:
            shared = _align16(shared + sizes[name])
    return _align16(shared + _stage_bytes(d)), scratch


def placement(d: int, m: int, L: int, force: bool = False) -> int | None:
    """``None`` where the sketch fits one block's shared memory (the
    shared-memory kernel), else the variant's mask of sections in device
    memory: the fewest, largest first (ties in the layout's order).
    ``force`` takes the variant even where the sketch would fit."""
    if not force and bytes_placed(d, m, L)[0] <= MAX_SMEM_BYTES:
        return None
    sizes = section_bytes(d, m, L, True)
    order = sorted(range(len(SECTIONS)), key=lambda i: -sizes[SECTIONS[i]])
    place = 0
    for i in order:
        if bytes_placed(d, m, L, True, place)[0] <= MAX_SMEM_BYTES:
            break
        place |= 1 << i
    return place


def moved(place: int | None) -> tuple[str, ...]:
    """The names of the sections a placement keeps in device memory."""
    return tuple(n for i, n in enumerate(SECTIONS)
                 if place is not None and place >> i & 1)
