"""mla_attention_roofline: the least time MLA's expanded attention of the
traced span's prefills could take, over the device time of the ops
launched under the program's ``repro_torch.attention`` region inside
``repro_torch.prefill``. A prefill of S tokens attends once per layer at
shape (1, heads, S, S, qk_nope + qk_rope, v_head_dim), causal; its bound
is the frozen mla_attention_cost at the card's peaks
(perfbench.yardstick). Reads a perfbench.spans.SpanProfile; nothing
from a plain Profile."""
from perfbench import yardstick


def read(run):
    p, c = run.profile, run.config
    if not hasattr(p, "spans") or not p.prefill_lens or \
            "kv_lora_rank" not in c:
        return None
    dev, n = p.under("repro_torch.attention", "repro_torch.prefill")
    if not n or dev <= 0:
        return None
    d_qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    us = sum(yardstick.bound(*yardstick.mla_attention_cost(
        (1, c["num_attention_heads"], S, S, d_qk, c["v_head_dim"], True,
         c["dtype"])), c["dtype"])[0]
        for S in p.prefill_lens) * c["num_hidden_layers"]
    return 100.0 * us / dev
