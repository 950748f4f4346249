"""repro_torch.analysis against the JAX reference's repro.analysis, on the
CPU: the memory model (with K1's Hopper shared-memory term) vs measured
bytes, the CUDA kernel audit, the determinism lints and dataflow over the
port (torch's RNG, atomic scatters, torch narrowing among them),
fingerprints and the baseline workflow, the CLI's exit-code contract, and
the construction-time budget guards.

Each test names the test of ``tests/test_analysis.py`` it mirrors; the
rest are the port's own (parity with the reference's memory model and
guards, and the planted violations of the port's new rules).
"""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from proptest import given, settings, st

from repro.analysis import memory_model as RM
from repro_torch.analysis import (MemoryBudgetError, load_baseline,
                                  memory_report, validate_params)
from repro_torch.analysis import dataflow, kernel_audit, lints, memory_model
from repro_torch.core.failures import FailSlow
from repro_torch.core.graph import build_workload
from repro_torch.core.recorder import record
from repro_torch.core.routing import Mesh2D
from repro_torch.core.sketch import (STAGE2_SLOT_BYTES, FailSlowSketch,
                                     SketchParams)
from repro_torch.core.sloth import Sloth, SlothConfig
from repro_torch.core.streaming import StreamingRecorder
from repro_torch.kernels._lib import MAX_SMEM_BYTES
from repro_torch.kernels.sketch_update import layout as k1_layout

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _cli(*argv, src=REPO / "src", cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv], cwd=cwd,
        env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def gate():
    """One run of the gate: ``--check all --baseline ... --json``."""
    r = _cli("--check", "all", "--baseline", "analysis/baseline.json",
             "--json")
    return r, json.loads(r.stdout) if r.returncode in (0, 1) else None


# ---------------------------------------------------------------------------
# the clean tree passes; each pass's planted violations are caught
# ---------------------------------------------------------------------------

# mirrors test_clean_tree_has_no_unbaselined_findings
def test_clean_tree_has_no_unbaselined_findings(gate):
    r, doc = gate
    assert doc is not None, r.stdout + r.stderr
    new = [row for row in doc["findings"] if not row["baselined"]]
    assert new == [], json.dumps(new, indent=1)


# mirrors test_memory_self_test
def test_memory_self_test():
    memory_model.self_test()


# mirrors test_kernel_audit_self_test
def test_kernel_audit_self_test():
    kernel_audit.self_test()


# mirrors test_lints_self_test
def test_lints_self_test():
    lints.self_test()


# mirrors test_dataflow_self_test
def test_dataflow_self_test():
    dataflow.self_test()


# mirrors test_cli_exit_codes
def test_cli_exit_codes(gate):
    ok, _ = gate
    assert ok.returncode == 0, ok.stdout + ok.stderr
    bad = _cli("--check", "memory", "--budget-kb", "1")
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "over-budget" in bad.stdout


# mirrors test_cli_budget_kb_rejected_for_non_memory_checks
def test_cli_budget_kb_rejected_for_non_memory_checks():
    r = _cli("--check", "lints", "--budget-kb", "100")
    assert r.returncode == 2, r.stdout + r.stderr
    assert "--budget-kb" in r.stderr
    assert _cli("--check", "memory", "--budget-kb", "512")\
        .returncode == 0


# mirrors test_cli_json_includes_fingerprints_and_timings
def test_cli_json_includes_fingerprints_and_timings(gate):
    r, doc = gate
    assert r.returncode == 0, r.stdout + r.stderr
    assert doc["ok"] and doc["new"] == 0
    assert set(doc["timings"]) == {"memory", "kernels", "lints",
                                   "dataflow"}
    assert all(t >= 0 for t in doc["timings"].values())
    for row in doc["findings"]:
        assert row["baselined"] is True
        assert len(row["fingerprint"]) == 16


# mirrors test_cli_exit_codes and the CLI's --self-test
def test_cli_self_test_exit_code():
    r = _cli("--self-test", "--check", "kernels")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "self-test OK (kernels)" in r.stdout


# mirrors test_each_pass_flags_its_synthetic_violation
def test_each_pass_flags_its_synthetic_violation():
    rep = memory_report(SketchParams(m=65536), impl="batched")
    assert rep["total_budget_bytes"] > 256 * 1024
    fs = kernel_audit.audit_kernel(
        kernel_audit._SYNTHETIC_CU, "<s.cu>", kernel_audit._SYNTHETIC_OPS,
        "<s.py>")
    assert any(f.rule == "float-atomic" for f in fs)
    fs = lints.lint_source("import numpy as np\n"
                           "x = np.random.rand(3)\n", "<s>")
    assert any(f.rule == "unseeded-rng" for f in fs)


# ---------------------------------------------------------------------------
# the port's new rules: each planted violation caught, its benign twin not
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,line", [
    ("import torch\ntorch.manual_seed(0)\n", 2),
    ("import torch\nx = torch.randn(3)\n", 2),
    ("import torch\nx = torch.randperm(5)\n", 2),
    ("import torch\ndef f(x):\n    return torch.randn_like(x)\n", 3),
    ("import torch\ndef f(x):\n    x.bernoulli_(0.5)\n", 3),
    ("import torch\ng = torch.Generator(device='cpu')\n", 2),
    ("from torch import Generator\ng = Generator()\n", 2),
])
def test_torch_rng_flagged(src, line):
    fs = lints.lint_source(src, "<s>")
    assert [(f.rule, f.line) for f in fs] == [("unseeded-rng", line)]


@pytest.mark.parametrize("src", [
    "import torch\ndef f(seed):\n"
    "    g = torch.Generator().manual_seed(seed)\n"
    "    return torch.randn(3, generator=g)\n",
    "import torch\ndef f(seed, x):\n    g = torch.Generator()\n"
    "    g.manual_seed(seed)\n    x.uniform_(generator=g)\n",
    "import torch\nx = torch.randn(3)  # lint: allow-rng (benchmark)\n",
])
def test_torch_rng_seeded_forms_stay_clean(src):
    assert lints.lint_source(src, "<s>") == []


@pytest.mark.parametrize("call", [
    "out.index_add_(0, idx, src)", "out.index_add(0, idx, src)",
    "out.scatter_add_(0, idx, src)", "torch.scatter_add(out, 0, idx, src)",
    "out.scatter_reduce_(0, idx, src, 'sum')",
    "out.index_put_((idx,), src, accumulate=True)",
    "out.index_put_((idx,), src, True)",
    "out.put_(idx, src, accumulate=True)",
])
def test_atomic_scatter_flagged(call):
    src = f"import torch\ndef f(out, idx, src):\n    {call}\n"
    fs = lints.lint_source(src, "<s>")
    assert [(f.rule, f.line) for f in fs] == [("atomic-scatter", 3)]
    marked = src.rstrip("\n") + "  # lint: allow-atomic-scatter (int)\n"
    assert lints.lint_source(marked, "<s>") == []
    plain = src.replace(", accumulate=True", "").replace(", True)", ")")
    if "index_put" in call or "put_" in call:
        assert lints.lint_source(plain, "<s>") == []


def test_atomic_scatter_scope_covers_the_card_modules():
    assert set(lints.RNG_SCOPE) < set(lints.ATOMIC_SCOPE)
    assert {"models", "optim"} <= set(lints.ATOMIC_SCOPE)


def _sketch_cu() -> str:
    return (PKG / "csrc/sketch_insert.cu").read_text()


def _sketch_ops() -> str:
    return (PKG / "kernels/sketch_update/ops.py").read_text()


def _audit(cu, ops):
    return kernel_audit.audit_kernel(cu, "src/repro_torch/csrc/x.cu", ops,
                                     "src/repro_torch/kernels/x/ops.py")


@pytest.mark.parametrize("mutation,rule", [
    # a float atomic in K1's kernel (the lints' atomics, one level down)
    (("if (live) atomicAdd(&flags[1], live);",
      "if (live) atomicAdd(&flags[1], live);\n"
      "  atomicAdd((float*)&flags[1], 1.0f);"), "float-atomic"),
    (("if (live) atomicAdd(&flags[1], live);",
      "if (live) atomicAdd(&flags[1], live);\n  asm volatile(\"red.shared"
      ".add.f32 [%0], %1;\" :: \"r\"(0), \"f\"(1.f));"), "float-atomic"),
    # an integer atomic the contract does not list
    (("if (code) atomicOr(&flags[0], code);",
      "if (code) atomicXor(&flags[0], code);"), "undeclared-atomic"),
    # a block per run chunk: one sketch's run order split across blocks
    (("<<<count, NT, smem", "<<<count * 4, NT, smem"), "grid-drift"),
    # an entry point grown by a parameter the binding does not pass
    (("long long sketch_insert_smem_bytes(int d, int m, int L)",
      "long long sketch_insert_smem_bytes(int d, int m, int L, int H)"),
     "binding-drift"),
])
def test_kernel_audit_catches_planted_drift(mutation, rule):
    cu = _sketch_cu()
    assert _audit(cu, _sketch_ops()) == []
    old, new = mutation
    assert cu.count(old) == 1
    fs = _audit(cu.replace(old, new), _sketch_ops())
    assert fs and {f.rule for f in fs} == {rule}, \
        "\n".join(f.render() for f in fs)


def test_kernel_audit_catches_binding_and_contract_drift():
    ops = _sketch_ops()
    fs = _audit(_sketch_cu(), ops.replace(
        "argtypes = [ctypes.c_int] * 3", "argtypes = [ctypes.c_int] * 2"))
    assert [f.rule for f in fs] == ["binding-drift"]
    fs = _audit(_sketch_cu(), ops.replace('"atomicOr")', ')'))
    assert [f.rule for f in fs] == ["undeclared-atomic"]
    fs = _audit(_sketch_cu(), ops.replace('"float_atomics": 0',
                                          '"float_atomics": "0"'))
    assert [f.rule for f in fs] == ["missing-audit-contract"]
    fs = kernel_audit.audit_kernel(_sketch_cu(), "x.cu", ops, "x.py",
                                   has_plain=False)
    assert [f.rule for f in fs] == ["missing-plain-version"]


def test_kernel_audit_reports_an_unpaired_source(tmp_path):
    shutil.copytree(PKG, tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src/repro_torch/csrc/orphan.cu").write_text(
        "__global__ void k() {}\n")
    fs = kernel_audit.check(tmp_path)
    assert [(f.rule, f.path) for f in fs] == [
        ("missing-audit-contract", "src/repro_torch/csrc/orphan.cu")]


def test_smem_over_limit_planted():
    wide = SketchParams(d=2, m=64, H=4, L=4096)
    assert memory_model.hopper_smem_bytes(wide) > MAX_SMEM_BYTES
    fs = memory_model.geometry_findings("wide", "<s>", wide, "batched",
                                        1e6)
    assert [f.rule for f in fs] == ["smem-over-limit"]
    assert memory_model.geometry_findings("wide", "<s>", wide, "ref",
                                          1e6) == []
    pod = SketchParams(d=2, m=1024, H=4, L=2048)
    assert memory_model.geometry_findings("pod", "<s>", pod, "batched",
                                          256) == []


# ---------------------------------------------------------------------------
# the memory model against the reference's, and K1's shared memory
# ---------------------------------------------------------------------------

def test_hopper_smem_bytes_at_the_pod_geometry():
    p = SketchParams(d=2, m=1024, H=4, L=2048)
    assert memory_model.hopper_smem_bytes(p) == 228_992
    assert MAX_SMEM_BYTES - memory_model.hopper_smem_bytes(p) == 3_456
    assert memory_model.SKETCH_ARGS_BYTES == 304


#: Geometries of the placement tests: the shipped ones, the paper's Fig 13
#: sketches past shared memory, d = 8, and L past 4,096 (16-bit slots).
PLACEMENT_GEOMETRIES = [(2, 1024, 1024), (2, 1024, 2048), (1, 8, 2),
                        (2, 4096, 1024), (4, 4096, 1024), (8, 1024, 1024),
                        (8, 8192, 64), (2, 64, 4096), (2, 1024, 8192),
                        (8, 65536, 8192), (1, 1, 65536)]


@pytest.mark.parametrize("d,m,L", PLACEMENT_GEOMETRIES)
def test_k1_placement_rule_against_hopper_smem_bytes(d, m, L):
    """The wrapper's rule (``layout.placement``): the shared-memory kernel
    exactly where ``hopper_smem_bytes`` fits a block (its layout byte for
    byte); else the variant with the fewest sections in device memory,
    largest first, so that what stays fits and no smaller set would."""
    p = SketchParams(d=d, m=m, H=4, L=L)
    shared = memory_model.hopper_smem_bytes(p)
    assert k1_layout.bytes_placed(d, m, L) == (shared, 0)
    place = k1_layout.placement(d, m, L)
    assert (place is None) == (shared <= MAX_SMEM_BYTES)
    assert memory_model.k1_path(p) == ("shared" if place is None else
                                       "device:" + ",".join(
                                           k1_layout.moved(place)))
    forced = k1_layout.placement(d, m, L, force=True)
    for mask in ([place] if place is not None else []) + [forced]:
        smem, scratch = k1_layout.bytes_placed(d, m, L, True, mask)
        assert smem <= MAX_SMEM_BYTES
        sizes = k1_layout.section_bytes(d, m, L, True)
        names = k1_layout.moved(mask)
        assert scratch == sum(-(-sizes[n] // 16) * 16 for n in names)
        # largest first: every section kept is no larger than one moved
        kept = [n for n in k1_layout.SECTIONS if n not in names]
        assert all(sizes[k] <= sizes[n] for k in kept for n in names)
        # fewest: without the smallest moved section it would not fit
        if names:
            last = min(names, key=lambda n: (sizes[n], -k1_layout.SECTIONS
                                             .index(n)))
            less = mask & ~(1 << k1_layout.SECTIONS.index(last))
            assert k1_layout.bytes_placed(d, m, L, True, less)[0] \
                > MAX_SMEM_BYTES
    if L > 4096:
        assert place is not None     # 16-bit slots end at 4,096 rows


def test_k1_placement_keeps_the_chain_state_on_chip_for_fig13():
    """For the paper's Fig 13 sketches past shared memory only Stage 1
    moves: the Stage-2 warp's rows, index, slots, ring and bitmap stay."""
    for d, m in ((2, 4096), (4, 4096)):
        assert k1_layout.moved(k1_layout.placement(d, m, 1024)) == ("t1",)
    assert k1_layout.placement(2, 1024, 2048) is None       # the pod's
    assert memory_model.k1_path(SketchParams()) == "shared"


@pytest.mark.parametrize("impl", ["ref", "batched"])
@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("m", [16, 64, 257, 1024])
@pytest.mark.parametrize("L", [8, 33, 256, 1024])
def test_memory_report_equals_reference(impl, d, m, L):
    """Key for key, but the reference's Pallas VMEM term for the port's
    Hopper shared memory (and its limit beside it) and the path K1 takes."""
    ref = RM.memory_report(RM.SketchParams(d=d, m=m, H=3, L=L), impl=impl)
    got = memory_report(SketchParams(d=d, m=m, H=3, L=L), impl=impl)
    assert got.pop("max_smem_bytes") == MAX_SMEM_BYTES
    for side in ("comp", "comm"):
        assert ref["sides"][side].pop("pallas_vmem_bytes") > 0
        assert got["sides"][side].pop("hopper_smem_bytes") \
            == memory_model.hopper_smem_bytes(SketchParams(d=d, m=m, H=3,
                                                           L=L))
        assert got["sides"][side].pop("k1_path") == memory_model.k1_path(
            SketchParams(d=d, m=m, H=3, L=L))
    assert got == ref


@pytest.mark.parametrize("impl", ["ref", "batched"])
@pytest.mark.parametrize("geometry,budget", [
    ((2, 1024, 4, 1024), 256), ((2, 1024, 4, 2048), 256),
    ((2, 4096, 4, 1024), 256), ((1, 64, 4, 8), 1), ((2, 65536, 4, 1024),
                                                    None),
    ((2, 1024, 4, 1024), 140), ((2, 1024, 4, 1024), 160)])
def test_guards_accept_and_reject_as_the_reference(impl, geometry, budget):
    d, m, H, L = geometry

    def outcome(validate, params):
        try:
            validate(params, impl=impl, budget_kb=budget)
        except ValueError as e:
            return type(e).__name__, str(e)
        return None

    assert outcome(validate_params, SketchParams(d, m, H, L)) \
        == outcome(RM.validate_params, RM.SketchParams(d, m, H, L))


# ---------------------------------------------------------------------------
# memory model == measured bytes (property tests, both impls)
# ---------------------------------------------------------------------------

# mirrors test_static_model_matches_array_nbytes
@settings(max_examples=15, deadline=None)
@given(st.data())
def test_static_model_matches_array_nbytes(data):
    from repro_torch.kernels.sketch_update import ref as kref
    p = SketchParams(d=data.draw(st.integers(1, 4)),
                     m=data.draw(st.sampled_from([16, 64, 257, 1024])),
                     H=data.draw(st.integers(1, 8)),
                     L=data.draw(st.sampled_from([8, 33, 256, 1024])))
    cap = data.draw(st.sampled_from([0, 1, 7, 256]))

    sk = FailSlowSketch(p)
    measured_ref = sum(a.nbytes for a in
                       (sk.keys_lo, sk.keys_hi, sk.valid, sk.freq))
    assert measured_ref == memory_model.ref_stage1_nbytes(p)

    state = kref.make_state(p)
    assert sum(int(v.nbytes) for v in state.values()) \
        == memory_model.packed_state_bytes(p)

    drain = kref.make_drain(cap)
    assert sum(int(v.nbytes) for v in drain.values()) \
        == memory_model.drain_bytes(cap)

    assert memory_model.accounting_bytes(p) == p.total_bytes()


@pytest.fixture(scope="module")
def deployment():
    sloth = Sloth(build_workload("darknet19"), Mesh2D(4), device="cpu")
    sim = sloth.run([FailSlow("core", 5, 1.0, 8.0, 10.0)], seed=0)
    return sloth, sim


# mirrors test_static_footprint_equals_measured_onchip
@pytest.mark.parametrize("impl", ["ref", "batched"])
@pytest.mark.parametrize("geometry", [
    SketchParams(),                         # defaults, no eviction
    SketchParams(d=2, m=256, H=4, L=8),     # forced FIFO eviction
])
def test_static_footprint_equals_measured_onchip(deployment, impl,
                                                 geometry):
    sloth, sim = deployment
    out = record(sim, geometry, hop_latency=sloth.sim_cfg.hop_latency,
                 impl=impl, device="cpu")
    static = 2 * memory_model.accounting_bytes(geometry)  # comp + comm
    assert out.onchip_bytes() == static
    drained = out.n_comp_drained + out.n_comm_drained
    assert out.sketch_bytes == static + drained * STAGE2_SLOT_BYTES
    if geometry.L == 8:
        assert drained > 0   # the small Stage-2 actually evicted


# mirrors test_streaming_footprint_matches_static
@pytest.mark.parametrize("impl", ["ref", "batched"])
def test_streaming_footprint_matches_static(deployment, impl):
    from repro_torch.core.streaming import split_sim
    sloth, sim = deployment
    p = SketchParams(d=2, m=256, H=4, L=8)
    rec = StreamingRecorder(p, hop_latency=sloth.sim_cfg.hop_latency,
                            impl=impl, device="cpu")
    for chunk in split_sim(sim, 4):
        rec.observe(chunk)
    out = rec.output()
    assert out.onchip_bytes() == 2 * memory_model.accounting_bytes(p)


# ---------------------------------------------------------------------------
# construction-time budget guards
# ---------------------------------------------------------------------------

# mirrors test_over_budget_sloth_config_rejected
def test_over_budget_sloth_config_rejected():
    cfg = SlothConfig(sketch=SketchParams(m=65536))
    with pytest.raises(MemoryBudgetError, match="over the .* budget"):
        Sloth(build_workload("darknet19"), Mesh2D(4), cfg=cfg,
              device="cpu")


# mirrors test_budget_none_disables_guard
def test_budget_none_disables_guard():
    cfg = SlothConfig(sketch=SketchParams(m=4096), budget_kb=None)
    Sloth(build_workload("darknet19"), Mesh2D(4), cfg=cfg, device="cpu")


# mirrors test_default_configs_fit_budget
def test_default_configs_fit_budget():
    Sloth(build_workload("darknet19"), Mesh2D(4), device="cpu")
    Sloth(build_workload("darknet19"), Mesh2D(4),
          cfg=SlothConfig(recorder_impl="batched"), device="cpu")


# mirrors test_streaming_recorder_guard
def test_streaming_recorder_guard():
    with pytest.raises(MemoryBudgetError):
        StreamingRecorder(SketchParams(m=65536), device="cpu")
    StreamingRecorder(SketchParams(m=65536), budget_kb=None, device="cpu")
    with pytest.raises(MemoryBudgetError):
        validate_params(SketchParams(), SketchParams(m=65536))


# mirrors test_budget_error_message_is_actionable
def test_budget_error_message_is_actionable():
    try:
        StreamingRecorder(SketchParams(m=65536), impl="batched",
                          device="cpu")
    except MemoryBudgetError as e:
        msg = str(e)
        assert "KiB" in msg and "budget_kb" in msg and "m=65536" in msg
    else:
        pytest.fail("no MemoryBudgetError raised")


# ---------------------------------------------------------------------------
# exact per-slot drained accounting (non-divisible geometry)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _HeaderedParams(SketchParams):
    """A Stage-2 layout with a fixed 24-byte header: stage2_bytes() is
    no longer an exact multiple of L."""

    def stage2_bytes(self) -> int:
        return 24 + self.L * self.stage2_slot_bytes()


# mirrors test_drained_accounting_is_exact_per_slot
def test_drained_accounting_is_exact_per_slot():
    p = _HeaderedParams(d=2, m=1024, H=1, L=7)
    assert p.stage2_bytes() % p.L != 0
    sk = FailSlowSketch(p)
    for k in range(p.L + 20):
        sk.insert(k + 1, 1.0, 1.0, float(k))
    n = len(sk.drained)
    assert n > 0
    exact = p.total_bytes() + n * STAGE2_SLOT_BYTES
    assert sk.compressed_bytes() == exact
    old = p.total_bytes() + n * (p.stage2_bytes() // p.L)
    assert old != exact


# mirrors test_slot_accounting_independent_of_L
@settings(max_examples=10, deadline=None)
@given(st.integers(1, 200), st.integers(2, 31))
def test_slot_accounting_independent_of_L(extra, L):
    rng = np.random.default_rng(extra * 31 + L)
    p = SketchParams(d=1, m=64, H=1, L=L)
    sk = FailSlowSketch(p)
    for k in range(L + extra):
        sk.insert(int(k + 1), float(rng.random()), 1.0, float(k))
    per = (sk.compressed_bytes() - p.total_bytes()) / max(
        len(sk.drained), 1)
    if sk.drained:
        assert per == STAGE2_SLOT_BYTES


# ---------------------------------------------------------------------------
# kernel audit: the shipped contracts describe the shipped kernels
# ---------------------------------------------------------------------------

# mirrors test_kernel_audit_contracts_present_and_consistent
def test_kernel_audit_contracts_present_and_consistent():
    findings = kernel_audit.check()
    assert findings == [], "\n".join(f.render() for f in findings)
    files = {f.parent.name: f for f in PKG.glob("kernels/*/ops.py")}
    assert set(files) == {"sketch_update", "flash_attention",
                          "ssd_scan", "failrank_step"}
    for name, f in files.items():
        assert "AUDIT" in f.read_text(), f"{name} lost its contract"
    contracts = kernel_audit.contracts()
    assert set(contracts) == {p.stem for p in PKG.glob("csrc/*.cu")}
    assert all(c["float_atomics"] == 0 for c in contracts.values())
    assert {k for c in contracts.values() for k in c["int_atomics"]} \
        == {"sketch_insert_runs_kernel", "flash_bwd_bf16_hopper_kernel"}


# mirrors test_kernel_audit_catches_grid_rank_drift
def test_kernel_audit_catches_grid_drift():
    """Launching K1 on another grid without updating AUDIT is flagged."""
    src = _sketch_cu().replace("<<<count, NT", "<<<(count + 1) / 2, NT")
    fs = _audit(src, _sketch_ops())
    assert [f.rule for f in fs] == ["grid-drift"]
    assert fs[0].symbol == "sketch_insert_runs"


# mirrors test_lint_wallclock_allowlist_is_tight
def test_lint_wallclock_allowlist_is_tight():
    """campaign.py keeps exactly one blessed wall-clock reader."""
    src = (PKG / "core/campaign.py").read_text()
    assert src.count("time.perf_counter()") == 1
    assert "# lint: allow-wallclock" in src
    stripped = src.replace("# lint: allow-wallclock", "")
    fs = lints.lint_source(stripped, "<campaign>")
    assert any(f.rule == "wallclock" for f in fs)


# ---------------------------------------------------------------------------
# dataflow pass: planted violations per rule (interprocedural)
# ---------------------------------------------------------------------------

def _df(modules):
    return dataflow.analyze_modules(modules)


# mirrors test_dataflow_literal_seed_flagged
@pytest.mark.parametrize("body", [
    "    return torch.Generator().manual_seed(0)\n",
    "    g = torch.Generator(device='cpu')\n    g.manual_seed(3)\n"
    "    return g\n",
    "    return np.random.default_rng(0)\n",
])
def test_dataflow_literal_seed_flagged(body):
    fs = _df({"p.core.m": (
        "import numpy as np\nimport torch\ndef k():\n" + body,
        "src/repro_torch/core/m.py")})
    assert [f.rule for f in fs] == ["literal-seed"]


# mirrors test_dataflow_seeded_arguments_stay_clean
def test_dataflow_seeded_arguments_stay_clean():
    fs = _df({
        "p.core.lib": (
            "import numpy as np\n"
            "import torch\n"
            "def stream(x):\n"
            "    return np.random.default_rng(x)\n"
            "def gen(x, dev):\n"
            "    return torch.Generator(device=dev).manual_seed(x)\n",
            "src/repro_torch/core/lib.py"),
        "p.core.use": (
            "from .lib import gen, stream\n"
            "def f(cfg, args, base_seed, dev):\n"
            "    a = stream(cfg.seed)\n"
            "    b = stream(args.seed)\n"
            "    c = stream([base_seed, 3, 7])\n"
            "    d = gen(args.seed, dev)\n"
            "    return a, b, c, d\n",
            "src/repro_torch/core/use.py")})
    assert fs == [], "\n".join(f.render() for f in fs)


# mirrors test_dataflow_unseeded_provenance_traced_across_modules
def test_dataflow_unseeded_provenance_traced_across_modules():
    fs = _df({
        "p.core.lib": (
            "import torch\n"
            "def gen(x):\n"
            "    return torch.Generator().manual_seed(x)\n",
            "src/repro_torch/core/lib.py"),
        "p.core.use": (
            "from .lib import gen\n"
            "def f(values):\n"
            "    return gen(len(values))\n",
            "src/repro_torch/core/use.py")})
    hit = [f for f in fs if f.rule == "unseeded-provenance"]
    assert hit and hit[0].path.endswith("lib.py")
    assert hit[0].symbol == "gen"


# mirrors test_dataflow_cross_module_narrowing_flagged
@pytest.mark.parametrize("narrow", [
    "x.to(torch.bfloat16)", "x.to(torch.float16)", "x.to(x.device, "
    "torch.half)", "x.bfloat16()", "x.half()",
    "torch.zeros(3, dtype=torch.bfloat16)"])
def test_dataflow_cross_module_narrowing_flagged(narrow):
    def pkg(expr):
        return {
            "p.core.pack": (
                "import torch\n"
                "def pack(x):\n"
                f"    return {expr}\n",
                "src/repro_torch/core/pack.py"),
            "p.core.use": (
                "from .pack import pack\n"
                "def f(x):\n"
                "    return pack(x) * 2\n",
                "src/repro_torch/core/use.py")}
    fs = _df(pkg(narrow))
    assert [f.rule for f in fs] == ["cross-module-narrowing"]
    # the same shape with a widening cast, a device move or a dtype
    # parameter stays clean
    for fine in ("x.to(torch.float32)", "x.to(x.device)", "x.float()",
                 "x.to(x.dtype)"):
        assert _df(pkg(fine)) == []


# mirrors test_dataflow_unsorted_accumulation_flagged
def test_dataflow_unsorted_accumulation_flagged():
    src = ("def merge(parts):\n"
           "    acc = 0.0\n"
           "    for v in parts.values():\n"
           "        acc += v\n"
           "    return acc\n")
    fs = _df({"p.core.m": (src, "src/repro_torch/core/m.py")})
    assert any(f.rule == "unsorted-accumulation" for f in fs)
    src_int = ("def count(parts):\n"
               "    n = 0\n"
               "    for v in parts.values():\n"
               "        n += 1\n"
               "    return n\n")
    assert _df({"p.core.m": (src_int, "src/repro_torch/core/m.py")}) == []


# mirrors test_dataflow_unordered_sum_and_fixes
def test_dataflow_unordered_sum_and_fixes():
    bad = ("def t(parts):\n"
           "    return sum(parts.values())\n")
    fs = _df({"p.core.m": (bad, "src/repro_torch/core/m.py")})
    assert any(f.rule == "unordered-sum" for f in fs)
    good = ("import math\n"
            "def t(parts):\n"
            "    return sum(sorted(parts.values()))\n"
            "def u(parts):\n"
            "    return math.fsum(parts.values())\n")
    assert _df({"p.core.m": (good, "src/repro_torch/core/m.py")}) == []


# ---------------------------------------------------------------------------
# fingerprints + baseline workflow
# ---------------------------------------------------------------------------

# mirrors test_fingerprint_stable_under_line_shifts
def test_fingerprint_stable_under_line_shifts():
    body = ("import torch\n"
            "def k():\n"
            "    return torch.Generator().manual_seed(0)\n")
    shifted = ("import torch\n"
               "# a comment\n\n\n"
               "def unrelated():\n"
               "    return 1\n\n"
               "def k():\n"
               "    return torch.Generator().manual_seed(0)\n")
    f1 = _df({"p.core.m": (body, "src/repro_torch/core/m.py")})
    f2 = _df({"p.core.m": (shifted, "src/repro_torch/core/m.py")})
    assert len(f1) == len(f2) == 1
    assert f1[0].line != f2[0].line
    assert f1[0].symbol == f2[0].symbol == "k"
    assert f1[0].fingerprint == f2[0].fingerprint
    # the kernel audit's findings keep theirs too (symbol: the function)
    cu = _sketch_cu().replace("<<<count, NT", "<<<2 * count, NT")
    g1 = _audit(cu, _sketch_ops())
    g2 = _audit(cu.replace("#include <stdint.h>",
                           "#include <stdint.h>\n\n// moved\n"),
                _sketch_ops())
    assert g1[0].line + 3 == g2[0].line
    assert g1[0].fingerprint == g2[0].fingerprint


# mirrors test_fingerprint_distinguishes_rule_and_symbol
def test_fingerprint_distinguishes_rule_and_symbol():
    fs = _df({"p.core.m": (
        "import torch\n"
        "def k1():\n"
        "    return torch.Generator().manual_seed(0)\n"
        "def k2():\n"
        "    return torch.Generator().manual_seed(7)\n",
        "src/repro_torch/core/m.py")})
    fps = {f.fingerprint for f in fs}
    assert len(fps) == len(fs) == 2


# mirrors test_baseline_round_trip (on a copy of the package, the lints)
def test_baseline_round_trip(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(PKG, src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bl = tmp_path / "bl.json"
    wrote = _cli("--check", "lints", "--update-baseline", str(bl), src=src)
    assert wrote.returncode == 0, wrote.stdout + wrote.stderr
    ok = _cli("--check", "lints", "--baseline", str(bl), src=src)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    (src / "repro_torch/core/_planted_analysis_smoke.py").write_text(
        "import torch\nx = torch.rand(3)\n")
    bad = _cli("--check", "lints", "--baseline", str(bl), src=src)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "unseeded-rng" in bad.stdout and "_planted" in bad.stdout


# mirrors test_shipped_baseline_is_tight
def test_shipped_baseline_is_tight(gate):
    _, doc = gate
    live = {row["fingerprint"] for row in doc["findings"]}
    baseline = load_baseline()
    stale = set(baseline) - live
    assert not stale, \
        f"stale baseline entries: {  {fp: baseline[fp] for fp in stale} }"
