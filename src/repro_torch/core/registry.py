# Copied from src/repro/core/registry.py; only the import paths differ.
"""Spec-string grammar shared by the experiment-facing registries.

Transports, radio technologies and collection policies are all addressed by
*spec strings* of the form

    name
    name:key=value
    name:key=value,key2=value2

(DESIGN.md §5) so a whole experiment variant fits in one `ScenarioConfig`
string field and sweeps stay declarative — ``"mesh:hops=3"``,
``"lora:sf=12"``, ``"bursty:burst=8"``. This module owns the grammar:
:func:`parse_spec` splits a spec into ``(name, params)`` with numeric/bool
coercion, and :func:`format_spec` renders the canonical form back
(sorted keys), so ``format_spec(*parse_spec(s))`` is a stable round-trip
for any valid spec.

**Nested (channel) specs** (DESIGN.md §8). A spec may itself appear as a
parameter *value* of an outer spec — the multi-host launcher's executor
spec embeds a whole ``HostChannel`` spec::

    hosts:channel=ssh:hosts=edge-a;edge-b;edge-c,n=3,retries=2

Two grammar rules make this nest without escaping: the outer grammar
splits parameters on ``","`` only and takes the *first* ``"="`` of a
segment as the key/value boundary, so an embedded spec may freely contain
``":"``, ``"="`` and ``";"``; and the nested channel grammar uses
``sep=";"`` with ``merge_unkeyed=True`` — a ``";"``-segment without its
own ``"="`` *continues the previous value* (``"ssh:hosts=a;b;c"`` parses
to ``{"hosts": "a;b;c"}``), which is what makes ``";"`` double as both
the channel parameter separator and the host-list separator.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple


def _coerce(raw: str) -> Any:
    """int | float | bool | str, in that order of preference."""
    low = raw.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw.strip()


def parse_spec(spec: str, *, sep: str = ",",
               merge_unkeyed: bool = False) -> Tuple[str, Dict[str, Any]]:
    """``"mesh:hops=3,paywall=false"`` -> ``("mesh", {"hops": 3, ...})``.

    The bare form ``"mesh"`` parses to ``("mesh", {})``. Raises
    :class:`ValueError` on malformed parameter segments (missing ``=``,
    empty key), so registries can surface the offending spec verbatim.

    ``sep``/``merge_unkeyed`` select the *nested channel grammar* (module
    docstring): parameters split on ``sep`` (``";"`` for channel specs),
    and with ``merge_unkeyed=True`` a segment without its own ``"="``
    continues the previous parameter's value — ``"ssh:hosts=a;b;c"``
    parses to ``("ssh", {"hosts": "a;b;c"})`` instead of erroring. Merged
    values stay strings (coercion happens once, on the final value).
    """
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(f"empty transport/policy spec: {spec!r}")
    name, colon, tail = spec.partition(":")
    name = name.strip()
    raw: Dict[str, str] = {}
    if colon and not tail.strip():
        raise ValueError(f"spec {spec!r} has a ':' but no parameters")
    if tail.strip():
        last_key = None
        for part in tail.split(sep):
            key, eq, val = part.partition("=")
            if not eq and merge_unkeyed and last_key is not None \
                    and part.strip():
                raw[last_key] = f"{raw[last_key]}{sep}{part.strip()}"
                continue
            if not eq or not key.strip() or not val.strip():
                raise ValueError(
                    f"malformed parameter {part!r} in spec {spec!r} "
                    f"(expected key=value)")
            last_key = key.strip()
            raw[last_key] = val.strip()
    return name, {k: _coerce(v) for k, v in raw.items()}


def format_spec(name: str, params: Dict[str, Any] | None = None, *,
                sep: str = ",") -> str:
    """Canonical spec string: params sorted by key, bools lowercase.
    ``sep=";"`` renders the nested channel grammar."""
    if not params:
        return name
    def render(v: Any) -> str:
        if isinstance(v, bool):
            return "true" if v else "false"
        return str(v)
    body = sep.join(f"{k}={render(params[k])}" for k in sorted(params))
    return f"{name}:{body}"


def register_factory(registry: Dict[str, Any], name: str, factory: Any,
                     kind: str) -> None:
    """Shared registration rule: idempotent for the same factory object,
    :class:`ValueError` on a conflicting re-registration."""
    prev = registry.get(name)
    if prev is not None and prev is not factory:
        raise ValueError(f"{kind} {name!r} already registered")
    registry[name] = factory


def resolve_spec(spec: str, factories: Dict[str, Any],
                 cache: Dict[str, Any], kind: str, *,
                 sep: str = ",", merge_unkeyed: bool = False) -> Any:
    """Shared spec-string resolution: parse → look up factory → construct
    with the params as kwargs → cache under both the given and the
    canonical spelling. Unknown names, malformed specs and unknown
    parameter *names* raise :class:`KeyError` (fail-fast registries);
    invalid parameter *values* propagate as the factory's
    :class:`ValueError`.

    ``sep``/``merge_unkeyed`` select the nested channel grammar (module
    docstring) for registries whose parameter values are themselves spec
    strings — the sweep service's config grammar
    (``serve:port=8080;backend=hosts:channel=local,n=2``) resolves with
    ``sep=";"``, ``merge_unkeyed=True`` so an embedded executor/channel
    spec nests without escaping."""
    obj = cache.get(spec)
    if obj is not None:
        return obj
    try:
        name, params = parse_spec(spec, sep=sep,
                                  merge_unkeyed=merge_unkeyed)
    except ValueError as e:
        raise KeyError(str(e)) from e
    factory = factories.get(name)
    if factory is None:
        raise KeyError(f"no {kind} registered for {spec!r}; known: "
                       f"{sorted(factories)}")
    try:
        obj = factory(**params)
    except TypeError as e:
        raise KeyError(f"bad parameters for {kind} {spec!r}: {e}") from e
    cache[spec] = obj
    cache.setdefault(format_spec(name, params, sep=sep), obj)
    return obj
