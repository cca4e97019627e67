"""decode_launches: the device ops (kernels, copies, memsets) launched
under the program's ``repro_torch.decode_step`` span, per decode step, in
the traced span (a perfbench.spans.SpanProfile; nothing from a plain
Profile)."""

STEP = "repro_torch.decode_step"


def read(run):
    p = run.profile
    if not hasattr(p, "spans"):
        return None
    ops = p.under(STEP)[1]
    return ops / p.calls(STEP) if ops else None
