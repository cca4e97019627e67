"""One reader per metric, found by name (perfbench.registry.metric)."""
