"""ssd_scan_roofline: the least time the traced span's ssd_scan calls
could take, over the device time of their kernels (every kernel whose
name starts ``ssd_``: the tensor-core route's three, or the CUDA-core
route's one). Each prefill of S tokens makes one call per layer of shape
(1, S, heads, head_dim, state, chunk); its bound is the frozen ssd_cost
at the card's peaks (perfbench.yardstick)."""
from perfbench import yardstick


def read(run):
    p, c = run.profile, run.config
    if p is None or not p.prefill_lens or "state_size" not in c:
        return None
    dev, n = p.kernel_s(lambda name: "ssd_" in name and "kernel" in name)
    if not n or dev <= 0:
        return None
    d_inner = c["expand"] * c["hidden_size"]
    H = d_inner // c["head_dim"]
    us = sum(yardstick.bound(*yardstick.ssd_cost(
        (1, S, H, c["head_dim"], c["state_size"], c["chunk_size"],
         c["dtype"])), c["dtype"])[0]
        for S in p.prefill_lens) * c["num_hidden_layers"]
    return 100.0 * us / 1e6 / dev
