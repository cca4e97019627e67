"""The sweep service layer, port of ``repro.service``: a streaming HTTP
RPC control plane over the port's sweep machinery — server, client, exact
result cache and dependency-free statsd metrics. Stdlib-only on top of
``repro_torch.core``.

Heavy imports are deferred: ``from repro_torch.service import statsd``
imports neither torch nor the core engines (the launcher's metrics hook
relies on it)."""
from repro_torch.service.statsd import Statsd, statsd   # noqa: F401

__all__ = ["Statsd", "statsd"]
