"""mla_prefill_us_per_token: the device us of the ops launched under the
program's ``repro_torch.mla.*`` spans and its ``repro_torch.attention``
region inside ``repro_torch.prefill`` (MLA's q, latent, attention and
out products), over the prompt tokens of the traced span's prefills (a
perfbench.spans.SpanProfile; nothing from a plain Profile)."""

PREFILL = "repro_torch.prefill"


def read(run):
    p = run.profile
    if not hasattr(p, "spans") or not p.prefill_lens:
        return None
    mla_us, mla_ops = p.under("repro_torch.mla.", PREFILL)
    att_us, att_ops = p.under("repro_torch.attention", PREFILL)
    if not mla_ops:
        return None
    return (mla_us + att_us) / sum(p.prefill_lens)
