"""prompt_tokens_per_s: prompt tokens of every prefill whose first token
reached the host in the window, over the window's length."""


def read(run):
    s = run.stats
    return s.rate(s.prompt_tokens) if s.prompt_tokens else None
