"""The paper's own workload: CovType HTL scenarios (Section 5/6 defaults).

Port of ``repro.configs.covtype_htl``: the same ``ScenarioConfig``
constants, over the port's scenario module. Benchmarks sweep variations of
them (``core/experiment.py``'s ``paper_tables`` preset).
"""
from repro_torch.core.scenario import ScenarioConfig

# Fig. 2 benchmark: everything to the Edge Server over NB-IoT
EDGE_ONLY = ScenarioConfig(algo="edge_only", windows=100,
                           obs_per_window=100)

# Table 3 headline row: StarHTL over 802.11g, no data on the edge
SHTL_WIFI = ScenarioConfig(algo="star", tech="wifi", windows=100,
                           lam_poisson=7.0, zipf_alpha=1.5)

# Table 4: + the data-aggregation heuristic
SHTL_WIFI_AGG = ScenarioConfig(algo="star", tech="wifi", aggregate=True,
                               windows=100)

A2A_4G = ScenarioConfig(algo="a2a", tech="4g", windows=100)
