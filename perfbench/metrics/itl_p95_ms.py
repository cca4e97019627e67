"""itl_p95_ms: the 95th percentile of every gap between consecutive
tokens of a request on the host, over the gaps whose later token reached
the host in the window."""
from perfbench.timeline import p95


def read(run):
    v = p95(run.stats.itl_s)
    return None if v is None else 1e3 * v
