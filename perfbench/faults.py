"""Faults planted in the timed path, each a ``hook(model, batcher)`` that
``cell.run_cell`` calls once both are built. A run with any of them has
to come out not correct (``tests/test_perfbench_cell.py`` on the CPU;
``calibrate.py --fault <name>`` on the card, at a cell's own size).
"""


def altered_token(model, batcher):
    """The decode step's token altered where it is produced."""
    inner = model.decode_step

    def step(cache, tokens, pos):
        logits, cache = inner(cache, tokens, pos)
        return logits.roll(1, dims=-1), cache
    model.decode_step = step


def state_unchanged(model, batcher):
    """A decode step that returns its cache unchanged."""
    inner = model.decode_step

    def step(cache, tokens, pos):
        logits, _ = inner({k: v.clone() for k, v in cache.items()}, tokens,
                          pos)
        return logits, cache
    model.decode_step = step


def half_batch(model, batcher):
    """Half of the batch left out: its rows copied from the other half."""
    inner = model.decode_step

    def step(cache, tokens, pos):
        logits, cache = inner(cache, tokens, pos)
        h = logits.shape[0] // 2
        logits[h:2 * h] = logits[:h]
        return logits, cache
    model.decode_step = step


def wrong_slot(model, batcher):
    """A request's cache spliced into its neighbour's slot."""
    inner = batcher._splice
    batcher._splice = lambda slot, c: inner((slot + 1) % batcher.slots, c)


FAULTS = {f.__name__: f for f in (altered_token, state_unchanged,
                                  half_batch, wrong_slot)}
