from repro_torch.sharding.partitioning import (  # noqa: F401
    ParamModule, ParamSpec, init_params)
