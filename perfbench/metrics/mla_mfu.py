"""mla_mfu: mfu (metrics/mfu.py) of a dense model with Multi-head Latent
Attention: model FLOPs of the window's work over the window at the
card's bf16 peak, 2 N FLOPs per prompt token and per generated token, N
the parameters a token multiplies, from the configuration's widths
(perfbench.yardstick_mla); attention's scores are not counted, so this
is a lower bound of the step's share of the peak. Stated against the
published peak at 700 W; the run prints the card's power limit."""
from perfbench import yardstick, yardstick_mla


def read(run):
    s = run.stats
    tokens = s.prompt_tokens + s.output_tokens
    if not tokens:
        return None
    peak = yardstick.PEAK_FLOPS_PER_S[run.config["dtype"]]
    return 100.0 * yardstick_mla.model_flops(run.config, tokens) / (
        s.seconds * peak)
