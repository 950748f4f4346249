"""The port's kernel build settings (``kernels/_lib.py``), on the CPU.

Only the sketch insert and the FailRank step are built with
``-fmad=false``: their checks against the plain versions are exact.  Flash
attention and the SSD scan are held at a tolerance and build with FMA.  A
library's file name carries a hash of its source and its own flags, so a
changed flag rebuilds it.  Loading and launch counting are thread-safe.
"""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from repro_torch.kernels import _lib


@pytest.mark.parametrize("name,exact", [
    ("sketch_insert", True), ("failrank_step", True),
    ("flash_attention", False), ("ssd_scan", False)])
def test_only_the_exact_kernels_turn_off_fma(name, exact):
    flags = _lib.flags(name)
    assert ("-fmad=false" in flags) is exact
    assert "arch=compute_90a,code=sm_90a" in flags
    assert (_lib.CSRC / f"{name}.cu").exists()


def test_library_name_follows_the_flags(monkeypatch):
    before = _lib._target("ssd_scan")
    assert before.parent == _lib.BUILD
    assert before.name.startswith("libssd_scan-")
    monkeypatch.setitem(_lib.SOURCE_FLAGS, "ssd_scan", ("-fmad=false",))
    assert _lib._target("ssd_scan") != before
    assert _lib._target("flash_attention").name.startswith(
        "libflash_attention-")


def test_every_source_has_launch_counters():
    names = {p.stem for p in _lib.CSRC.glob("*.cu")}
    assert names == {"sketch_insert", "failrank_step", "flash_attention",
                     "ssd_scan"}
    assert {"sketch_insert_runs", "sketch_insert_runs_device",
            "failrank_step", "flash_attention",
            "flash_attention_prefill", "flash_attention_decode",
            "flash_attention_bf16", "flash_attention_bf16_prefill",
            "flash_attention_bf16_decode", "flash_attention_bwd",
            "flash_attention_bf16_bwd", "ssd_scan", "ssd_scan_bf16",
            "ssd_scan_bwd", "ssd_scan_bf16_bwd"} == set(_lib.LAUNCHES)
    _lib.LAUNCHES["flash_attention_decode"] += 3
    _lib.reset_launches()
    assert not any(_lib.LAUNCHES.values())


def test_load_builds_once_and_counts_lose_nothing_under_threads(monkeypatch):
    """Threads of the campaign's thread executor may all find a library
    unbuilt: one builds and loads it while the others wait (two builds
    would write one temporary file: one pid).  Launch counts are read-
    modify-writes and must not lose an update."""
    starts = []

    def fake_start(name):
        starts.append(name)
        time.sleep(0.05)                     # hold the build window open
        return _lib.BUILD / f"lib{name}-fake.so", None

    monkeypatch.setattr(_lib, "_start", fake_start)
    monkeypatch.setattr(_lib.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_lib, "_libs", {})
    with ThreadPoolExecutor(8) as pool:
        libs = list(pool.map(lambda _: _lib.load("sketch_insert"),
                             range(16), timeout=60))
    assert starts == ["sketch_insert"]
    assert all(lib is libs[0] for lib in libs)

    class Key(str):
        """A name whose hash runs Python code, so that a thread switch can
        fall between the read and the write of an unlocked update."""
        def __hash__(self):
            return str.__hash__(self)

        def __eq__(self, other):
            return str.__eq__(self, other)

    key = Key("ssd_scan")
    _lib.reset_launches()
    per_thread, n_threads = 5000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_lib.count(key) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _lib.LAUNCHES["ssd_scan"] == per_thread * n_threads
    _lib.reset_launches()
