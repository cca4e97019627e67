"""mla_mfu: mfu (metrics/mfu.py) of a model with Multi-head Latent
Attention, under a name of its own: model FLOPs of the window's work
over the window at the card's bf16 peak, 2 N FLOPs per prompt token and
per generated token, N the parameters a token multiplies, from the
configuration's widths (perfbench.yardstick, which counts MLA where the
file gives its widths); attention's scores are not counted, so this is
a lower bound of the step's share of the peak. Stated against the
published peak at 700 W; the run prints the card's power limit."""
from perfbench.metrics.mfu import read  # noqa: F401
