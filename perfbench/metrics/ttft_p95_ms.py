"""ttft_p95_ms: the 95th percentile, over every request whose first token
reached the host in the window, of the time from its client's send to
that token."""
from perfbench.timeline import p95


def read(run):
    v = p95(run.stats.ttft_s)
    return None if v is None else 1e3 * v
