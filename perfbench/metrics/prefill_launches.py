"""prefill_launches: the device ops (kernels, copies, memsets) launched
under the program's ``repro_torch.prefill`` span, per prefill, in the
traced span (a perfbench.spans.SpanProfile; nothing from a plain
Profile)."""

PREFILL = "repro_torch.prefill"


def read(run):
    p = run.profile
    if not hasattr(p, "spans"):
        return None
    ops = p.under(PREFILL)[1]
    return ops / p.calls(PREFILL) if ops else None
