"""prefill_ms_per_ktok: the window's total of the synchronised host clock
around each ``Model.prefill`` the batcher made, over its prompt tokens in
thousands (traced run)."""


def read(run):
    calls = run.prefill_calls
    tokens = sum(n for _, n in calls)
    return 1e3 * sum(t for t, _ in calls) / (tokens / 1e3) if tokens \
        else None
