"""decode_step_ms: the window's total of the synchronised host clock
around each ``Model.decode_step``, over the number of steps (traced
run)."""


def read(run):
    calls = run.decode_calls
    return 1e3 * sum(calls) / len(calls) if calls else None
