"""output_tokens_per_s: every token that reached the host in the window
(first tokens and decoded tokens), over the window's length."""


def read(run):
    s = run.stats
    return s.rate(s.output_tokens) if s.output_tokens else None
