"""device_idle: the share of the traced span in which no kernel or copy
ran on the card: one less the union of the device intervals over the
span (torch.profiler)."""


def read(run):
    p = run.profile
    if p is None or not p.kernels or p.span_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.span_s)
