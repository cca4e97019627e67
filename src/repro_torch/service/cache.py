"""Exact sweep-result cache keyed by canonical config hash.

Port of ``repro.service.cache``. The bitwise-determinism contract — a
sweep's ``SweepResult`` JSON is a pure function of (physical run list,
dataset bytes, stack mode, device type), identical across backends, shard
counts, retries and worker crashes — is exactly the property that makes
result caching *exact* rather than approximate: serving the stored bytes
IS re-running the sweep. chip_smoke.py and tests/test_torch_service.py
diff a cache hit byte-for-byte against a fresh recomputation.

The key is a sha256 over the inputs of that pure function:

* ``SweepSpec.canonical_hash()`` — the expanded run list as canonical
  JSON (sorted keys; invariant to dict key order, process restarts and
  spec refactorings that expand identically; distinct for any
  axis/seed/base change; equal to the reference's hash);
* the dataset digest — sha256 over the base64 buffer payloads of the
  launcher wire codec (:func:`repro_torch.core.launcher.encode_dataset`),
  i.e. over the exact float bits every worker decodes (equal to the
  reference's digest);
* the stack mode and the result-schema version (a schema bump must never
  serve bytes written by an older reader's layout);
* the device type (``"cuda"`` or ``"cpu"``): float32 on another processor
  rounds differently, so card and CPU results are different pure
  functions, and a request for one is never served the other's bytes.

Storage is an in-memory dict with an optional spill directory: entries
written as ``<key>.json`` (atomic rename), re-read on miss — so a
restarted service warms from disk, and two services sharing a directory
share a cache. Hit/miss/store counters feed ``service.cache.*`` in
:mod:`repro_torch.service.statsd`.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

from repro_torch.service.statsd import statsd

CACHE_SCHEMA = 1


def dataset_digest(encoded: Mapping[str, Any]) -> str:
    """sha256 of an encoded-dataset payload (wire codec of
    :mod:`repro_torch.core.launcher`): hashes dtype/shape/base64 buffers in
    field order, so two datasets digest equal iff their bits are equal."""
    h = hashlib.sha256()
    for name in sorted(encoded["fields"]):
        f = encoded["fields"][name]
        h.update(name.encode())
        h.update(str(f["dtype"]).encode())
        h.update(str(f["shape"]).encode())
        h.update(f["b64"].encode())
    return h.hexdigest()


def cache_key(spec_hash: str, data_digest: str, stack: str, *,
              device="cuda", search: str = "") -> str:
    """The exact-result cache key: all inputs of the deterministic sweep
    function, plus the schema version. ``device`` enters as its type
    (``"cuda"`` for ``"cuda:1"`` too; no torch import, the cache stays
    stdlib-only): card and CPU bytes never share a key, while two cards
    do. ``search`` is the *canonical* search spec for
    Pareto-search jobs — a search's ``ParetoResult`` is a different pure
    function of the same grid, so it must never collide with the plain
    sweep's bytes; it only enters the hashed blob when non-empty."""
    blob: Dict[str, Any] = {"schema": CACHE_SCHEMA, "spec": spec_hash,
                            "data": data_digest, "stack": stack,
                            "device": str(device).split(":", 1)[0]}
    if search:
        blob["search"] = search
    text = json.dumps(blob, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()


class ResultCache:
    """Byte-exact result store: ``put`` the merged ``SweepResult`` JSON
    text, ``get`` it back verbatim. Thread-safe (the service's job threads
    store while request handlers look up). Memory entries are true-LRU
    (a hit refreshes recency, so the hottest key is the last evicted);
    hit telemetry distinguishes memory hits (``service.cache.hit``) from
    disk-warmed hits (``service.cache.hit_disk``)."""

    def __init__(self, directory: Optional[str] = None,
                 max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.directory = directory
        self.max_entries = max_entries
        self._mem: "OrderedDict[str, str]" = OrderedDict()
        self._lock = threading.Lock()
        if directory:
            os.makedirs(directory, exist_ok=True)

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.json")

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            text = self._mem.get(key)
            if text is not None:
                self._mem.move_to_end(key)      # true LRU: hits refresh
        if text is not None:
            statsd.increment("service.cache.hit")
            return text
        if self.directory:
            try:
                with open(self._path(key)) as f:
                    text = f.read()
            except OSError:
                text = None
            if text is not None:
                with self._lock:
                    self._remember(key, text)
                statsd.increment("service.cache.hit_disk")
                return text
        statsd.increment("service.cache.miss")
        return None

    def put(self, key: str, text: str) -> None:
        with self._lock:
            self._remember(key, text)
        if self.directory:
            # unique temp per writer: concurrent puts of the SAME key must
            # not share a temp path, or interleaved truncate/write/rename
            # can publish a partially-written file — each writer stages its
            # own file and the atomic rename decides the winner
            fd, tmp = tempfile.mkstemp(dir=self.directory,
                                       prefix=f".{key}.", suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(text)
                os.replace(tmp, self._path(key))  # readers never see partials
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        statsd.increment("service.cache.store")

    def _remember(self, key: str, text: str) -> None:
        self._mem[key] = text
        self._mem.move_to_end(key)
        while len(self._mem) > self.max_entries:
            self._mem.popitem(last=False)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._mem),
                    "max_entries": self.max_entries,
                    "directory": self.directory}
