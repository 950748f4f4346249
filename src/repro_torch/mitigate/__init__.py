"""Verdict-driven mitigation: act on detector output, measure recovery.

The detect → mitigate loop (ROADMAP item 6): a detector produces a
:class:`~repro_torch.core.detectors.Verdict`, a registered
:class:`~repro_torch.mitigate.policy.MitigationPolicy` turns it into a
:class:`~repro_torch.mitigate.policy.MitigationPlan` (cores to exclude, links to
detour), and the simulator re-runs the mitigated deployment over the
remaining failure window.  ``run_campaign(mitigation=...)`` judges every
detector × policy cell and :mod:`repro_torch.core.metrics` aggregates
*recovered throughput* — the sharpest end-to-end test of verdict quality,
because acting on a wrong verdict makes performance worse, not better.

Policies register exactly like detectors do: string-keyed factories via
:func:`register_policy`, built-ins pre-registered lazily.
"""

from .policies import (NonePolicy, QuarantinePolicy,  # noqa: F401
                       RemapPolicy, ReroutePolicy)
from .policy import (DEFAULT_POLICIES, MitigationPlan,  # noqa: F401
                     MitigationPolicy, available_policies, flagged_sites,
                     get_policy, instantiate_policy, register_policy,
                     work_done_frac)

__all__ = [
    "MitigationPlan", "MitigationPolicy", "DEFAULT_POLICIES",
    "register_policy", "get_policy", "available_policies",
    "instantiate_policy", "flagged_sites", "work_done_frac",
    "RemapPolicy", "ReroutePolicy", "QuarantinePolicy", "NonePolicy",
]
