"""flash_attention_roofline: the least time the traced span's flash
launches could take, over their device time. Each prefill of S tokens
makes one causal launch per layer of shape (1, heads, kv heads, S, S,
head_dim); its bound is the frozen flash_cost at the card's peaks
(perfbench.yardstick). Nothing to read without a prefill in the span."""
from perfbench import yardstick


def read(run):
    p, c = run.profile, run.config
    if p is None or not p.prefill_lens or "num_attention_heads" not in c:
        return None
    dev, n = p.kernel_s(lambda name: "flash_attention" in name)
    if not n or dev <= 0:
        return None
    us = sum(yardstick.bound(*yardstick.flash_cost(
        (1, c["num_attention_heads"], c["num_key_value_heads"], S, S,
         c["head_dim"], True, 0, 0, c["dtype"])), c["dtype"])[0]
        for S in p.prefill_lens) * c["num_hidden_layers"]
    return 100.0 * us / 1e6 / dev
