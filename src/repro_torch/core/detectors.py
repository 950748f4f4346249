"""Unified detector API: one :class:`Verdict`, one protocol, one registry.

* :class:`Verdict` — the single verdict type every detector returns: a
  ranked candidate list, the mesh it was judged on (so ``matches`` is
  router-aware via :func:`repro_torch.core.failures.truth_candidates`)
  and, for detectors that produce them, the recorder / FailRank / MCG
  artifacts.
* :class:`Detector` — the protocol: ``name``, ``prepare(graph, mesh,
  profile, cfg)`` and ``analyse(sim) → Verdict``.
* the registry — ``get_detector("sloth" | "thres" | "mscope" | "iaso" |
  "perseus" | "adr")`` resolves a factory; :func:`register_detector` adds
  user extensions.  Built-ins self-register on first lookup (lazy import
  of :mod:`.sloth` / :mod:`.baselines` avoids an import cycle).

The campaign layer (``campaign.py``) speaks only this API: a deployment
prepares one detector instance per requested name and every scenario's
trace is analysed by all of them, so ``run_campaign(grid,
detectors=("sloth", "thres", ...))`` produces the SLOTH-vs-baselines table
with no detector-specific glue.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Protocol, runtime_checkable

from .failures import FailSlow, truth_candidates
from .routing import Topology

if TYPE_CHECKING:                                    # pragma: no cover
    from .failrank import FailRankResult
    from .graph import CompGraph
    from .mcg import MCG
    from .recorder import RecorderOutput
    from .simulator import SimResult

__all__ = [
    "Verdict", "Detector", "register_detector", "get_detector",
    "available_detectors", "prepare_detector", "DEFAULT_DETECTORS",
]

#: Registry order of the built-in detectors: SLOTH first, then the five
#: baselines in the paper's Table III order.
DEFAULT_DETECTORS = ("sloth", "thres", "mscope", "iaso", "perseus", "adr")


@dataclasses.dataclass
class Verdict:
    """The one verdict type shared by every detector.

    ``ranking`` is the detector's ordered candidate list — multi-entry for
    every built-in, including the baselines, which list all resources
    above/near their statistic; ``flagged_resources`` lists every resource
    whose evidence independently clears the detector's threshold
    (multi-failure report).  ``recorder`` / ``failrank`` / ``mcg`` are
    populated by detectors that produce those artifacts (SLOTH) and
    ``None`` otherwise.
    """
    flagged: bool
    kind: str | None              # 'core' | 'link'
    location: int | None
    score: float
    ranking: list[tuple[str, int, float]] = dataclasses.field(
        default_factory=list)
    recorder: "RecorderOutput | None" = None
    failrank: "FailRankResult | None" = None
    mcg: "MCG | None" = None
    total_time: float = 0.0
    # every resource whose detection evidence clears the flag threshold,
    # sorted by raw evidence — the multi-failure report.  The verdict's
    # kind/location additionally weigh FailRank attribution, so the two
    # orderings may disagree on which resource comes first.
    flagged_resources: tuple[tuple[str, int, float], ...] = ()
    mesh: Topology | None = dataclasses.field(
        default=None, repr=False, compare=False)
    detector: str = ""            # registry name of the producing detector

    def matches(self, failure: FailSlow | None,
                mesh: Topology | None = None) -> bool:
        """Correctness of this verdict against ground truth, router-aware:
        a router truth is matched by any link of the slowed router (the
        detector only localises cores and links)."""
        if failure is None:
            return not self.flagged
        if not self.flagged:
            return False
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            if failure.kind == "router":
                raise ValueError(
                    "judging a router truth needs the mesh topology; pass "
                    "mesh= or use a Verdict produced by a prepared "
                    "detector")
            return (self.kind, self.location) == failure.label()
        return (self.kind, self.location) in truth_candidates(failure, mesh)


@runtime_checkable
class Detector(Protocol):
    """A fail-slow detector bound to one (workload, mesh) deployment.

    Life cycle: construct unprepared via the registry factory, then
    ``prepare(graph, mesh, profile, cfg)`` fits nominal models against a
    healthy profiling run (``profile`` is a failure-free ``SimResult`` of
    the same deployment) and returns ``self``; ``analyse(sim)`` judges one
    instrumented trace.  ``prepare`` must be deterministic in its inputs —
    the campaign's process-pool workers rebuild detectors independently
    and their verdicts must be bit-identical to the parent's.

    ``cfg`` carries implementation selection as well as thresholds: e.g.
    ``SlothConfig.recorder_impl`` chooses the SL-Recorder sketch path
    ("ref" oracle vs on-device "batched"), so the campaign layer can
    compare deployable pipelines purely through the config it hands to
    ``prepare``.
    """

    name: str

    def prepare(self, graph: "CompGraph", mesh: Topology,
                profile: "SimResult", cfg=None) -> "Detector":
        ...                                          # pragma: no cover

    def analyse(self, sim: "SimResult") -> Verdict:
        ...                                          # pragma: no cover


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], Detector]] = {}
_builtins_loaded = False


def register_detector(name: str, factory: Callable[[], Detector], *,
                      overwrite: bool = False) -> None:
    """Register ``factory`` (a zero-arg callable returning an unprepared
    detector) under ``name``.  Extension point for user detectors; the
    built-ins are pre-registered.  Note that campaign process-pool workers
    re-import modules in fresh interpreters, so a custom detector must be
    registered at import time of its defining module to be visible under
    ``executor='process'``."""
    key = str(name).lower()
    if not overwrite and key in _REGISTRY:
        raise ValueError(f"detector {key!r} is already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[key] = factory


def _register_builtin(name: str, factory: Callable[[], Detector]) -> None:
    """Registration used by the built-in modules at import time: first
    registration wins, so a user's earlier ``register_detector(name, ...,
    overwrite=True)`` override of a built-in name survives the lazy
    built-in import (and module re-imports stay idempotent)."""
    _REGISTRY.setdefault(str(name).lower(), factory)


def _ensure_builtins() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        # late import: sloth/baselines import Verdict from this module, so
        # registering them at our import time would be a cycle
        from . import baselines, sloth  # noqa: F401
        _builtins_loaded = True


def get_detector(name: str) -> Callable[[], Detector]:
    """Resolve a detector factory by registry name (case-insensitive)."""
    _ensure_builtins()
    key = str(name).lower()
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown detector {name!r}; available: "
            f"{available_detectors()}") from None


def available_detectors() -> tuple[str, ...]:
    """Registered detector names: built-ins first (in ``DEFAULT_DETECTORS``
    order), then user registrations in registration order."""
    _ensure_builtins()
    head = [n for n in DEFAULT_DETECTORS if n in _REGISTRY]
    tail = [n for n in _REGISTRY if n not in DEFAULT_DETECTORS]
    return tuple(head + tail)


def instantiate_detector(name: str) -> Detector:
    """Resolve ``name`` and instantiate an unprepared detector, enforcing
    the registry contract that the instance's ``.name`` equals its
    (lowercased) registry key — campaign outcome tables are keyed on
    ``.name``, so a mismatch would otherwise surface as missing-key
    errors long after registration."""
    key = str(name).lower()
    det = get_detector(key)()
    if getattr(det, "name", None) != key:
        raise ValueError(
            f"detector factory registered under {key!r} produced an "
            f"instance named {getattr(det, 'name', None)!r}; the registry "
            f"key and Detector.name must match (lowercase)")
    return det


def prepare_detector(name: str, graph: "CompGraph", mesh: Topology,
                     profile: "SimResult", cfg=None) -> Detector:
    """Convenience: resolve, instantiate and prepare in one call."""
    return instantiate_detector(name).prepare(graph, mesh, profile, cfg)
