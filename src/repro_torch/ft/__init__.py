from repro_torch.ft.resilience import (
    PreemptionHandler,
    StepWatchdog,
    StragglerPolicy,
)

__all__ = ["PreemptionHandler", "StepWatchdog", "StragglerPolicy"]
