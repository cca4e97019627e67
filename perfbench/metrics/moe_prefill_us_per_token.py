"""moe_prefill_us_per_token: the device us of the ops launched under the
program's ``repro_torch.moe.*`` spans inside ``repro_torch.prefill``, over
the prompt tokens of the traced span's prefills (a
perfbench.spans.SpanProfile; nothing from a plain Profile)."""


def read(run):
    p = run.profile
    if not hasattr(p, "spans") or not p.prefill_lens:
        return None
    us, ops = p.under("repro_torch.moe.", "repro_torch.prefill")
    return us / sum(p.prefill_lens) if ops else None
