"""Streaming client for the sweep service.

Port of ``repro.service.client``. Stdlib-only (``http.client`` + JSON)
counterpart of :mod:`repro_torch.service.server`: submit a
:class:`SweepSpec`, then *stream* per-shard events and fold each into an
incremental, order-stable merge
(:class:`repro_torch.core.parallel.ShardMerger`) — the client-side
replacement for the launcher's all-shards barrier. Because shards write
to disjoint run-index slots, any arrival order (and any replay after a
reconnect) merges to the same run list, so :meth:`ServiceClient.run`
returns a ``SweepResult`` whose JSON is byte-identical to the sequential
in-process ``spec.run(data, device=...)`` on the server's device.

Stream resumption: the server persists every job event with a sequence
number, so when a stream connection drops mid-job (server restarts a
worker, an LB idles the connection, or the server bounds the response
via ``max_events``), the client transparently reconnects with
``cursor=<next seq>`` and continues; the merger's idempotent ``add``
makes overlap harmless. Submit payloads are checked by
:func:`repro_torch.core.parallel.assert_host_only` before they leave the
process — the no-tensors-on-the-wire contract holds on both ends.
"""
from __future__ import annotations

import json
import socket
from http.client import HTTPConnection, HTTPException
from typing import Any, Dict, Iterator, Optional, Tuple, Union

from repro_torch.core.experiment import SweepResult, SweepSpec, records_from
from repro_torch.core.launcher import encode_dataset
from repro_torch.core.parallel import ShardMerger, assert_host_only
from repro_torch.service.server import SERVICE_SCHEMA

_RECONNECT_ERRORS = (ConnectionError, HTTPException, socket.timeout,
                     OSError)


class ClientError(RuntimeError):
    """A request the service rejected (``status`` carries the HTTP code,
    0 for transport-level failures)."""

    def __init__(self, status: int, detail: str):
        super().__init__(f"[{status}] {detail}")
        self.status = status
        self.detail = detail


class ServiceClient:
    """One service endpoint. ``address`` is ``"host:port"`` or a
    ``(host, port)`` pair; ``timeout`` is the per-connection socket
    timeout (streams block up to this long waiting for the next event,
    then the read fails and the client reconnects with its cursor)."""

    def __init__(self, address: Union[str, Tuple[str, int]],
                 timeout: float = 60.0, max_reconnects: int = 100):
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            self.host, self.port = host or "127.0.0.1", int(port)
        else:
            self.host, self.port = address[0], int(address[1])
        self.timeout = timeout
        self.max_reconnects = max_reconnects

    # -- plain JSON round-trips ----------------------------------------------
    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None) -> Any:
        status, raw = self._request_raw(method, path, body)
        try:
            payload = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ClientError(status, f"non-JSON response for {method} "
                                      f"{path}: {e}")
        if status >= 400:
            raise ClientError(status, str((payload or {}).get(
                "error", raw[:400])))
        return payload

    def _request_raw(self, method: str, path: str,
                     body: Optional[Dict[str, Any]] = None
                     ) -> Tuple[int, str]:
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            data = json.dumps(body) if body is not None else None
            headers = ({"Content-Type": "application/json"}
                       if data is not None else {})
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read().decode("utf-8")
        except _RECONNECT_ERRORS as e:
            raise ClientError(0, f"{method} {path} failed: {e}")
        finally:
            conn.close()

    # -- the service API -----------------------------------------------------
    def submit(self, spec: SweepSpec, data: Any, *, stack: str = "auto",
               backend: Optional[str] = None, cache: str = "use",
               search: str = "") -> Dict[str, Any]:
        """POST the sweep; returns the submit reply (job id, shard
        partition, cache key, ``cached`` flag). ``data`` is a
        :class:`Dataset` or an already-encoded wire payload. A non-empty
        ``search`` spec (``"halving:rungs=3,keep=0.5"``) makes the job a
        Pareto search over the grid — the reply carries
        ``kind="search"`` and no shard partition."""
        payload: Dict[str, Any] = {
            "schema": SERVICE_SCHEMA,
            "spec": spec.to_wire(),
            "data": data if isinstance(data, dict) else
            encode_dataset(data),
            "stack": stack,
            "cache": cache,
        }
        if backend is not None:
            payload["backend"] = backend
        if search:
            payload["search"] = search
        assert_host_only(payload, where="service request")
        return self._request("POST", "/v1/jobs", payload)

    def status(self, job: str) -> Dict[str, Any]:
        return self._request("GET", f"/v1/jobs/{job}")

    def cancel(self, job: str, cancel_token: str) -> Dict[str, Any]:
        """Cancel a job. ``cancel_token`` is the capability the submit
        reply returned — the server 403s any other value, so holding a
        job id alone does not grant cancellation."""
        return self._request("POST", f"/v1/jobs/{job}/cancel",
                             {"cancel_token": cancel_token})

    def metrics(self) -> Dict[str, Any]:
        return self._request("GET", "/v1/metrics")

    def health(self) -> Dict[str, Any]:
        return self._request("GET", "/v1/healthz")

    def result_text(self, job: str) -> str:
        """The merged result JSON exactly as the server stores (and
        caches) it — the verbatim parity surface."""
        status, raw = self._request_raw("GET", f"/v1/jobs/{job}/results")
        if status >= 400:
            try:
                detail = json.loads(raw).get("error", raw[:400])
            except json.JSONDecodeError:
                detail = raw[:400]
            raise ClientError(status, detail)
        return raw

    def result(self, job: str) -> SweepResult:
        return SweepResult.from_json(self.result_text(job))

    def result_page(self, job: str, page: int,
                    per_page: int) -> SweepResult:
        status, raw = self._request_raw(
            "GET", f"/v1/jobs/{job}/results?page={page}"
                   f"&per_page={per_page}")
        if status >= 400:
            raise ClientError(status, raw[:400])
        return SweepResult.from_json(raw)

    # -- streaming -----------------------------------------------------------
    def stream_events(self, job: str, cursor: int = 0, *,
                      max_events_per_conn: int = 0
                      ) -> Iterator[Dict[str, Any]]:
        """Yield the job's NDJSON events from ``cursor`` until the
        terminal event, transparently reconnecting (with the advancing
        cursor) when a connection drops or the server bounds a response.
        Replayed events after a reconnect are *not* filtered here — the
        merger's idempotent ``add`` handles them — but the cursor
        advances past everything yielded, so a reconnect never re-reads
        from zero."""
        reconnects = 0
        while True:
            path = f"/v1/jobs/{job}/stream?cursor={cursor}"
            if max_events_per_conn:
                path += f"&max_events={max_events_per_conn}"
            conn = HTTPConnection(self.host, self.port,
                                  timeout=self.timeout)
            dropped = False
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                if resp.status >= 400:
                    raise ClientError(resp.status,
                                      resp.read().decode()[:400])
                while True:
                    try:
                        line = resp.readline()
                    except _RECONNECT_ERRORS:
                        dropped = True
                        break
                    if not line:            # EOF: server closed cleanly
                        break
                    event = json.loads(line)
                    assert_host_only(event, where="service stream event")
                    cursor = event["seq"] + 1
                    yield event
                    if event["event"] in ("done", "error"):
                        return
            except _RECONNECT_ERRORS:
                dropped = True
            finally:
                conn.close()
            reconnects += 1
            if dropped and reconnects > self.max_reconnects:
                raise ClientError(0, f"stream for {job} dropped "
                                     f"{reconnects} times; giving up at "
                                     f"cursor {cursor}")

    def run(self, spec: SweepSpec, data: Any, *, stack: str = "auto",
            backend: Optional[str] = None, cache: str = "use",
            max_events_per_conn: int = 0) -> SweepResult:
        """Submit + stream + merge: the end-to-end replacement for an
        in-process ``spec.run(data)``. Returns as soon as the *last*
        shard lands (no server-side barrier in between — each shard is
        merged the moment its event arrives). The returned result's JSON
        is byte-identical to the sequential run's; service bookkeeping
        (job id, cache key, hit flag) rides the out-of-band ``meta``."""
        sub = self.submit(spec, data, stack=stack, backend=backend,
                          cache=cache)
        job = sub["job"]
        service_meta = {"job": job, "key": sub["key"],
                        "cached": sub["cached"],
                        "n_shards": sub["n_shards"]}
        if sub["cached"]:
            out = SweepResult.from_json(self.result_text(job))
            out.meta["service"] = service_meta
            return out
        labels = [lbl for lbl, _ in spec.configs()]
        merger = ShardMerger(len(labels), sub["shards"])
        for event in self.stream_events(
                job, max_events_per_conn=max_events_per_conn):
            if event["event"] == "shard":
                merger.add(event["shard"], event["result"],
                           event["dispatch_counts"])
            elif event["event"] == "error":
                raise ClientError(500, f"job {job} {event['state']}: "
                                       f"{event.get('error')}")
        out = SweepResult(name=sub["name"],
                          records=records_from(labels, merger.results()))
        out.meta["service"] = service_meta
        return out

    def search(self, spec: SweepSpec, data: Any, search: str, *,
               stack: str = "auto", backend: Optional[str] = None,
               cache: str = "use",
               on_rung: Optional[Any] = None) -> "Any":
        """Submit a Pareto search over ``spec``'s grid and stream its
        ``rung`` events until the terminal one, then fetch the stored
        :class:`~repro_torch.core.pareto.ParetoResult` verbatim — the
        service-side equivalent of ``get_search(search).run(spec, data)``
        (bitwise, including the embedded frontier ``SweepResult``).
        ``on_rung(record)`` fires per streamed rung event."""
        from repro_torch.core.pareto import ParetoResult

        sub = self.submit(spec, data, stack=stack, backend=backend,
                          cache=cache, search=search)
        job = sub["job"]
        if not sub["cached"]:
            for event in self.stream_events(job):
                if event["event"] == "rung" and on_rung is not None:
                    on_rung(event)
                elif event["event"] == "error":
                    raise ClientError(500, f"search job {job} "
                                           f"{event['state']}: "
                                           f"{event.get('error')}")
        out = ParetoResult.from_json(self.result_text(job))
        out.meta["service"] = {"job": job, "key": sub["key"],
                               "cached": sub["cached"],
                               "search": sub["search"]}
        return out
