"""Mitigation-policy protocol, plan type and string-keyed registry.

SLOTH's localisation only pays off when the system acts on it (the
faulty-accelerator reuse argument: degraded chips should keep serving by
steering work around bad resources).  This module mirrors the detector
registry in :mod:`repro_torch.core.detectors` one-for-one: a
:class:`MitigationPolicy` turns a detector :class:`~repro_torch.core.detectors.
Verdict` into a :class:`MitigationPlan` (which cores to stop placing work
on, which links to detour around) and then applies that plan to a
:class:`~repro_torch.core.mapping.MappedGraph`, producing the deployment the
simulator re-runs over the remaining failure window.

Policies are stateless and deterministic: ``plan`` and ``apply`` must be
pure functions of their arguments, because campaign process-pool workers
rebuild policies independently and their mitigated outcomes must stay
bit-identical to the serial executor's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

from ..core.detectors import Verdict
from ..core.mapping import MappedGraph
from ..core.routing import Topology

__all__ = [
    "MitigationPlan", "MitigationPolicy", "DEFAULT_POLICIES",
    "register_policy", "get_policy", "available_policies",
    "instantiate_policy", "flagged_sites", "work_done_frac",
]

#: Built-in policy names, in campaign/table order.
DEFAULT_POLICIES = ("remap", "reroute", "quarantine", "none")


@dataclasses.dataclass(frozen=True)
class MitigationPlan:
    """What a policy decided to do about one verdict.

    ``acted=False`` means the policy has nothing to act on (not-flagged
    verdict, or no site of a kind this policy handles) — ``apply`` is then
    the identity and the mitigated makespan equals the failed one, so the
    ``none`` control's recovered throughput is *exactly* zero.
    """
    policy: str
    acted: bool
    exclude_cores: tuple[int, ...] = ()   # cores dropped from placement
    avoid_links: tuple[int, ...] = ()     # links detoured around
    reason: str = ""                      # human-readable decision note


@runtime_checkable
class MitigationPolicy(Protocol):
    """A verdict-driven mitigation strategy.

    ``plan(verdict, mapped, mesh, cfg)`` decides the resource edits
    (``mapped`` may be ``None`` for plan-only consumers such as the pod
    telemetry bridge); ``apply(plan, mapped, cfg)`` materialises them into
    a new :class:`MappedGraph` without mutating the input.  Both must be
    deterministic — see the module docstring.
    """

    name: str

    def plan(self, verdict: Verdict, mapped: MappedGraph | None,
             mesh: Topology, cfg=None) -> MitigationPlan:
        ...

    def apply(self, plan: MitigationPlan, mapped: MappedGraph,
              cfg=None) -> MappedGraph:
        ...


# --- registry (mirrors core/detectors.py) --------------------------------

_REGISTRY: dict[str, Callable[[], MitigationPolicy]] = {}
_builtins_loaded = False


def register_policy(name: str, factory: Callable[[], MitigationPolicy], *,
                    overwrite: bool = False) -> None:
    """Register ``factory`` (a zero-arg callable returning a policy) under
    ``name``.  Extension point for user policies; the built-ins are
    pre-registered.  Campaign process-pool workers re-import modules in
    fresh interpreters, so a custom policy must be registered at import
    time of its defining module to be visible under ``executor='process'``.
    """
    key = str(name).lower()
    if not overwrite and key in _REGISTRY:
        raise ValueError(f"mitigation policy {key!r} is already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[key] = factory


def _register_builtin_policy(name: str,
                             factory: Callable[[], MitigationPolicy]) -> None:
    """Built-in registration: first registration wins, so a user's earlier
    ``register_policy(name, ..., overwrite=True)`` override of a built-in
    survives the lazy built-in import."""
    _REGISTRY.setdefault(str(name).lower(), factory)


def _ensure_builtins() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        from . import policies  # noqa: F401  (registers at import time)
        _builtins_loaded = True


def get_policy(name: str) -> Callable[[], MitigationPolicy]:
    """Resolve a policy factory by registry name (case-insensitive)."""
    _ensure_builtins()
    key = str(name).lower()
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown mitigation policy {name!r}; available: "
            f"{available_policies()}") from None


def available_policies() -> tuple[str, ...]:
    """Registered policy names: built-ins first (in ``DEFAULT_POLICIES``
    order), then user registrations in registration order."""
    _ensure_builtins()
    head = [n for n in DEFAULT_POLICIES if n in _REGISTRY]
    tail = [n for n in _REGISTRY if n not in DEFAULT_POLICIES]
    return tuple(head + tail)


def instantiate_policy(name: str) -> MitigationPolicy:
    """Resolve ``name`` and instantiate a policy, enforcing the registry
    contract that the instance's ``.name`` equals its (lowercased)
    registry key — mitigation tables are keyed on ``.name``."""
    key = str(name).lower()
    pol = get_policy(key)()
    if getattr(pol, "name", None) != key:
        raise ValueError(
            f"policy factory registered under {key!r} produced an instance "
            f"named {getattr(pol, 'name', None)!r}; the registry key and "
            f"MitigationPolicy.name must match (lowercase)")
    return pol


# --- verdict / stream helpers --------------------------------------------

def flagged_sites(verdict: Verdict) -> tuple[tuple[str, int], ...]:
    """The (kind, location) sites a verdict implicates, deduplicated in
    evidence order: every entry of ``flagged_resources`` when the detector
    reports per-resource flags (SLOTH), else the top-1 kind/location (the
    baselines leave ``flagged_resources`` empty)."""
    if not getattr(verdict, "flagged", False):
        return ()
    sites = [(str(k), int(loc)) for k, loc, _ in
             (getattr(verdict, "flagged_resources", ()) or ())]
    if not sites and verdict.kind is not None and verdict.location is not None:
        sites = [(str(verdict.kind), int(verdict.location))]
    return tuple(dict.fromkeys(sites))


def work_done_frac(sim, t: float) -> float:
    """FLOPs-weighted fraction of compute finished by stream time ``t``.

    Used to compose detection latency with recovery: a mid-stream
    mitigation at first flag keeps the work already completed and re-runs
    only the remainder on the mitigated deployment.
    """
    flops = sim.comp["flops"]
    total = float(flops.sum())
    if total <= 0.0:
        done = float((sim.comp["t_end"] <= t).mean()) if len(flops) else 1.0
        return min(max(done, 0.0), 1.0)
    done = float(flops[sim.comp["t_end"] <= t].sum()) / total
    return min(max(done, 0.0), 1.0)
