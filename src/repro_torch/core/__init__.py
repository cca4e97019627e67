"""The paper's primary contribution: HTL-based distributed learning with
energy accounting — the port of ``repro.core`` (the HTL pipeline; the
trainer, scan engine and orchestration modules come in later slices).
"""
from repro_torch.core.energy import (  # noqa: F401
    Ledger,
    TECHS,
    MODEL_BYTES,
    OBS_BYTES,
    resolve_tech,
)
from repro_torch.core.htl import DC, run_window_a2a, run_window_star  # noqa: F401
from repro_torch.core.topology import (  # noqa: F401
    Node,
    Topology,
    TRANSPORT_FACTORIES,
    get_transport,
    register_transport,
    transfer_counts,
)
from repro_torch.core.scenario import (  # noqa: F401
    COLLECTION_POLICIES,
    ScenarioConfig,
    ScenarioResult,
    register_collection_policy,
    run_scenario,
    run_sweep,
)
from repro_torch.core.experiment import (  # noqa: F401
    SweepSpec,
    SweepResult,
    get_preset,
)
