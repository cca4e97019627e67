"""moe_decode_us_per_token: the device us of the ops launched under the
program's ``repro_torch.moe.*`` spans inside ``repro_torch.decode_step``,
over the decode steps times the mix's slots, in the traced span (a
perfbench.spans.SpanProfile; nothing from a plain Profile)."""

STEP = "repro_torch.decode_step"


def read(run):
    p = run.profile
    if not hasattr(p, "spans"):
        return None
    us, ops = p.under("repro_torch.moe.", STEP)
    return us / (p.calls(STEP) * run.mix["slots"]) if ops else None
