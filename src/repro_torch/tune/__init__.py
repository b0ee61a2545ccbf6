"""``repro_torch.tune`` -- empirical tuning around the port planner's
analytic tiles (the counterpart of ``repro.tune``).

``tune.cache`` is the port's persisted artifact and its lookup API;
``tune.sweep`` is the measurement harness.  The planner (``core.plan`` /
``core.autotile`` / ``models.mamba2``) consults the artifact with
precedence analytic < tuned; ``python -m repro_torch.launch.tune`` runs the
sweeps end to end.
"""

from repro_torch.tune.cache import (
    TUNING_ENV,
    TuningEntry,
    entry_key,
    hw_fingerprint,
    load_tuning,
    lookup_tuned,
    record_tuned,
    tuning_path,
)
from repro_torch.tune.sweep import (
    Candidate,
    SweepResult,
    default_sweeps,
    run_sweeps,
    sweep_attention,
    sweep_matmul,
    sweep_paged,
    sweep_ssd,
    time_callable,
)

__all__ = [
    "TUNING_ENV",
    "TuningEntry",
    "Candidate",
    "SweepResult",
    "default_sweeps",
    "entry_key",
    "hw_fingerprint",
    "load_tuning",
    "lookup_tuned",
    "record_tuned",
    "run_sweeps",
    "sweep_attention",
    "sweep_matmul",
    "sweep_paged",
    "sweep_ssd",
    "time_callable",
    "tuning_path",
]
