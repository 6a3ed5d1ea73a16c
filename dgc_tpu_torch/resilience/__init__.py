"""Resilience (port of ``dgc_tpu.resilience``, the parts the serve tier
needs): ``faults`` (the fault-injection plane and its no-op
``fault_point``), ``retry`` (the error classifier and backoff),
``supervisor`` (the supervised sweep down an engine ladder, and the rung
state that feeds the serve tier's health) and ``domains`` (the lane
mesh's failure domains, health model and degrade/restore state machine).
The four are ``dgc_tpu``'s files verbatim but for the package name
(``tests/test_torch_import.py`` pins them). ``probe`` holds the restore
probe (``HealthProbe``, its canary in PyTorch on each slot's device). Not
ported: the CLI flags of the resilience layer (ROADMAP)."""

from dgc_tpu_torch.resilience.faults import (FaultPlane, FaultSchedule,
                                             FaultSpec, KILL_RC,
                                             SimulatedKill, fault_point)
from dgc_tpu_torch.resilience.retry import (ErrorClass, RetryBudget,
                                            RetryPolicy, classify_error)
from dgc_tpu_torch.resilience.supervisor import (AttemptTimeout,
                                                 DEFAULT_LADDER,
                                                 ResilienceStats,
                                                 RetryingEngine, RungFailure,
                                                 RungState,
                                                 STRUCTURED_ABORT_RC,
                                                 SweepAbort, default_ladder,
                                                 supervise_sweep)

__all__ = [
    "AttemptTimeout",
    "DEFAULT_LADDER",
    "ErrorClass",
    "FaultPlane",
    "FaultSchedule",
    "FaultSpec",
    "KILL_RC",
    "ResilienceStats",
    "RetryBudget",
    "RetryPolicy",
    "RetryingEngine",
    "RungFailure",
    "RungState",
    "STRUCTURED_ABORT_RC",
    "SimulatedKill",
    "SweepAbort",
    "classify_error",
    "default_ladder",
    "fault_point",
    "supervise_sweep",
]
