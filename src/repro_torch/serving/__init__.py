from repro_torch.serving.cache_utils import pad_cache, cache_bytes  # noqa: F401
from repro_torch.serving.engine import ServeEngine  # noqa: F401
