"""The port's kernel build settings (``kernels/_lib.py``), on the CPU.

Only the sketch insert and the FailRank step are built with
``-fmad=false``: their checks against the plain versions are exact.  Flash
attention and the SSD scan are held at a tolerance and build with FMA.  A
library's file name carries a hash of its source and its own flags, so a
changed flag rebuilds it.
"""

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
    assert {"sketch_insert_runs", "failrank_step", "flash_attention",
            "flash_attention_prefill", "flash_attention_decode",
            "ssd_scan"} == set(_lib.LAUNCHES)
    _lib.LAUNCHES["flash_attention_decode"] += 3
    _lib.reset_launches()
    assert not any(_lib.LAUNCHES.values())
