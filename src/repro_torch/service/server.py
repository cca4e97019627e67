"""The sweep service: a streaming HTTP RPC control plane over sweeps.

Port of ``repro.service.server``. Instead of every experiment being a
blocking in-process ``SweepSpec.run`` whose launcher barriers on all
shards, a long-running server accepts ``SweepSpec`` JSON over plain HTTP,
dispatches partition shards through the executor/`HostChannel` machinery
(:mod:`repro_torch.core.launcher`), and **streams each shard's
``SweepResult`` payload back the moment it lands** — NDJSON, one event
per line — so the client performs an incremental order-stable merge
(:class:`repro_torch.core.parallel.ShardMerger`) and the all-shards
barrier disappears from the client's critical path. Everything is
stdlib: ``http.server`` threads, JSON bodies, no framework.

The server's device is fixed at start-up (``device=``, ``--device``,
default ``"cuda"``): every job runs there, and the device type is part of
every cache key (:func:`repro_torch.service.cache.cache_key`).

Wire protocol (the reference's):

* ``POST /v1/jobs`` — body ``{"schema": 1, "spec": SweepSpec.to_wire(),
  "data": encode_dataset(...), "stack": "auto"|"off",
  "backend": "hosts:...", "cache": "use"|"bypass"|"off"}``. Replies with
  the job id, the shard partition (the client needs it to merge), the
  canonical cache key, and ``cached: true`` when the exact result cache
  already holds the bytes.
* ``GET /v1/jobs/<id>`` — job status (state, shards done/total,
  attempt counts).
* ``GET /v1/jobs/<id>/stream?cursor=K`` — NDJSON event stream starting
  at sequence ``K``. Events are persisted per job, so a disconnected
  client resumes by re-requesting with the last seen cursor — replays
  are idempotent at the merger. ``max_events=N`` bounds one response
  (operational knob + the reconnect test hook).
* ``GET /v1/jobs/<id>/results`` — the merged ``SweepResult`` JSON,
  **verbatim bytes** (the parity surface); ``?page=N&per_page=M`` pages
  large results via :meth:`SweepResult.page`.
* ``POST /v1/jobs/<id>/cancel`` — body ``{"cancel_token": ...}`` with
  the token the submit reply returned; sets the job's stop event so no
  new shard attempt starts (:meth:`HostsExecutor.execute_with_meta`).
  A missing or wrong token is a 403: only the submitter (or whoever it
  shares the token with) can cancel a job.
* ``GET /v1/metrics`` — the statsd snapshot + cache stats;
  ``GET /v1/healthz`` — liveness, queue depth and the device.

Determinism: a job's merged JSON is produced by exactly the machinery
the launcher proves bitwise — the shared shard runner, the shared
partitioner, the shared order-stable merge — so the served bytes equal
the sequential in-process run's bytes on the same device, clean, under
worker SIGKILL, and on a cache hit (chip_smoke.py,
tests/test_torch_service.py). Request/response payloads are guarded by
:func:`repro_torch.core.parallel.assert_host_only`: no torch tensor can
cross the service boundary in either direction.
"""
from __future__ import annotations

import json
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from repro_torch import resolve_device
from repro_torch.core.experiment import SweepResult, SweepSpec, records_from
from repro_torch.core.launcher import (HostsExecutor, LauncherError,
                                       get_channel)
from repro_torch.core.parallel import assert_host_only, partition_runs
from repro_torch.core.pareto import SearchCancelled, get_search
from repro_torch.core.registry import parse_spec
from repro_torch.core.scenario import validate_config
from repro_torch.service.cache import ResultCache, cache_key, dataset_digest
from repro_torch.service.statsd import statsd

SERVICE_SCHEMA = 1
DEFAULT_BACKEND = "hosts:channel=inline,n=2"


class ServiceError(RuntimeError):
    """A request the service rejected; ``status`` is the HTTP code."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class Job:
    """One submitted sweep: identity, partition, event log, lifecycle.

    The event log is the streaming source of truth — every per-shard
    payload and the terminal event are appended under the condition
    variable and kept for the job's lifetime, which is what makes streams
    resumable from any cursor (a reconnecting client never misses a
    shard; replays are de-duplicated by the client's merger)."""

    def __init__(self, job_id: str, spec: SweepSpec, stack: str,
                 shards: List[List[int]], key: str, cache_mode: str,
                 backend: str, search: str = ""):
        self.id = job_id
        self.spec = spec
        self.stack = stack
        self.shards = shards
        self.key = key
        self.cache_mode = cache_mode
        self.backend = backend
        # "" = plain sweep; otherwise the canonical search spec — the
        # job runs a Pareto search and streams `rung`
        # events instead of per-shard payloads
        self.search = search
        self.state = "queued"   # queued|running|done|failed|cancelled
        self.cached = False
        # capability token: returned once in the submit reply, required
        # by /cancel — never exposed via status()/metrics
        self.cancel_token = secrets.token_hex(16)
        self.events: List[Dict[str, Any]] = []
        self.cond = threading.Condition()
        self.stop = threading.Event()
        self.result_text: Optional[str] = None
        self.error: Optional[str] = None
        self.shards_done = 0
        self.attempts_total = 0
        self.t_submit = time.monotonic()
        self.t_first_shard: Optional[float] = None

    def append_event(self, event: Dict[str, Any]) -> None:
        with self.cond:
            event["seq"] = len(self.events)
            self.events.append(event)
            self.cond.notify_all()

    def finish(self, state: str, *, cached: bool = False,
               error: Optional[str] = None) -> None:
        with self.cond:
            self.state = state
            self.cached = cached
            self.error = error
        kind = "done" if state == "done" else "error"
        event: Dict[str, Any] = {"event": kind, "state": state,
                                 "cached": cached}
        if error is not None:
            event["error"] = error
        self.append_event(event)

    def terminal(self) -> bool:
        return self.state in ("done", "failed", "cancelled")

    def wait_events(self, cursor: int, timeout: float = 10.0
                    ) -> List[Dict[str, Any]]:
        """Events from ``cursor`` on; blocks up to ``timeout`` for a new
        one when the log is drained and the job still runs."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while len(self.events) <= cursor and not self.terminal():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self.cond.wait(remaining)
            return list(self.events[cursor:])

    def status(self) -> Dict[str, Any]:
        with self.cond:
            return {"job": self.id, "state": self.state,
                    "cached": self.cached, "name": self.spec.name,
                    "kind": "search" if self.search else "sweep",
                    "search": self.search,
                    "n_shards": len(self.shards),
                    "shards_done": self.shards_done,
                    "attempts_total": self.attempts_total,
                    "events": len(self.events), "error": self.error,
                    "key": self.key, "backend": self.backend}


class SweepService:
    """Job manager: submit → dispatch shards (streaming) → cache result.

    ``backend`` is a ``hosts`` executor spec (the launcher's nested
    grammar) — channels ARE the service's execution backends; the default
    ``inline`` channel runs shards in-process, so a warm server answers
    small jobs without per-worker import and CUDA-context cost.
    ``max_jobs`` bounds concurrently *running* jobs (a semaphore; excess
    jobs queue, visible as the ``service.jobs.queued`` gauge). ``device``
    is where every job runs, fixed for the service's life; a CUDA device
    without CUDA raises here, at start-up."""

    def __init__(self, backend: str = DEFAULT_BACKEND,
                 cache: Optional[ResultCache] = None, max_jobs: int = 2,
                 device="cuda"):
        if max_jobs < 1:
            raise ValueError(f"max_jobs must be >= 1, got {max_jobs}")
        resolve_device(device)
        self.device = str(device)
        self.backend = backend
        self.cache = cache if cache is not None else ResultCache()
        self._jobs: Dict[str, Job] = {}
        self._lock = threading.Lock()
        self._sem = threading.Semaphore(max_jobs)
        self._n_jobs = 0
        self._queued = 0
        self._running = 0
        self._executor(backend)     # fail fast on a bad default backend

    # -- backend resolution -------------------------------------------------
    @staticmethod
    def _executor(spec: str) -> HostsExecutor:
        """A *fresh* hosts executor per job (never the shared
        ``get_executor`` cache: per-job fault-injection params must not
        leak into other jobs). Only ``hosts`` specs stream per shard, so
        only they are accepted as service backends."""
        name, params = parse_spec(spec)
        if name != "hosts":
            raise ServiceError(
                400, f"service backend must be a 'hosts:...' executor "
                     f"spec (channels are the service backends), got "
                     f"{spec!r}")
        try:
            executor = HostsExecutor(**params)
            executor._resolve_channel()     # fail fast on a bad channel
            return executor
        except (TypeError, ValueError, KeyError) as e:
            raise ServiceError(400, f"bad backend spec {spec!r}: {e}")

    @staticmethod
    def _shard_count(ex: HostsExecutor) -> int:
        if ex.n is not None:
            return ex.n
        channel = ex.channel if not isinstance(ex.channel, str) \
            else get_channel(ex.channel)
        return max(1, len(channel.slots()))

    # -- lifecycle ----------------------------------------------------------
    def submit(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if payload.get("schema") != SERVICE_SCHEMA:
            raise ServiceError(400, f"unsupported submit schema "
                                    f"{payload.get('schema')!r} (this "
                                    f"service speaks {SERVICE_SCHEMA})")
        assert_host_only(payload, where="service request")
        stack = payload.get("stack", "auto")
        if stack not in ("auto", "off"):
            raise ServiceError(400, f"stack must be 'auto' or 'off', got "
                                    f"{stack!r}")
        cache_mode = payload.get("cache", "use")
        if cache_mode not in ("use", "bypass", "off"):
            raise ServiceError(400, f"cache must be use|bypass|off, got "
                                    f"{cache_mode!r}")
        backend = payload.get("backend", self.backend)
        encoded = payload.get("data")
        if not isinstance(encoded, dict) or encoded.get("kind") != "arrays":
            raise ServiceError(400, "submit payload needs an encoded "
                                    "dataset under 'data' (launcher wire "
                                    "codec)")
        search = payload.get("search", "")
        search_spec = ""
        if search:
            try:
                search_spec = get_search(search).spec
            except (KeyError, ValueError) as e:
                raise ServiceError(400, f"bad search spec {search!r}: {e}")
        try:
            spec = SweepSpec.from_wire(payload["spec"])
            runs = spec.configs()
            for _, cfg in runs:
                validate_config(cfg)
        except (KeyError, TypeError, ValueError) as e:
            raise ServiceError(400, f"bad SweepSpec payload: {e}")
        executor = self._executor(backend)
        cfgs = [c for _, c in runs]
        # search jobs stream rung events, not per-shard payloads: the
        # executor shards each rung internally, so the submit reply
        # carries no client-mergeable partition
        shards = [] if search_spec else \
            [list(s) for s in
             partition_runs(cfgs, self._shard_count(executor)) if s]
        key = cache_key(spec.canonical_hash(), dataset_digest(encoded),
                        stack, device=self.device, search=search_spec)
        with self._lock:
            self._n_jobs += 1
            job_id = f"job-{self._n_jobs:06d}"
            job = Job(job_id, spec, stack, shards, key, cache_mode,
                      backend, search=search_spec)
            self._jobs[job_id] = job
        statsd.increment("service.jobs.submitted")
        if search_spec:
            statsd.increment("service.jobs.search")

        cached_text = (self.cache.get(key) if cache_mode == "use" else
                       None)
        if cached_text is not None:
            job.result_text = cached_text
            job.shards_done = len(shards)
            job.finish("done", cached=True)
            statsd.increment("service.jobs.completed")
        else:
            with self._lock:
                self._queued += 1
            self._update_gauges()
            thread = threading.Thread(
                target=self._run_job, args=(job, executor, encoded),
                name=f"sweep-{job_id}", daemon=True)
            thread.start()
        return {"schema": SERVICE_SCHEMA, "job": job.id,
                "cached": job.cached, "name": spec.name,
                "kind": "search" if search_spec else "sweep",
                "search": search_spec,
                "n_runs": len(runs), "n_shards": len(shards),
                "shards": job.shards, "key": key,
                "cancel_token": job.cancel_token}

    def _update_gauges(self) -> None:
        with self._lock:
            queued, running = self._queued, self._running
        statsd.gauge("service.jobs.queued", queued)
        statsd.gauge("service.jobs.running", running)

    def _run_job(self, job: Job, executor: HostsExecutor,
                 encoded: Dict[str, Any]) -> None:
        from repro_torch.core.launcher import decode_dataset

        with self._sem:
            with self._lock:
                self._queued -= 1
                self._running += 1
            self._update_gauges()
            with job.cond:
                job.state = "running"
            t0 = time.monotonic()
            try:
                data = decode_dataset(encoded)
                if job.search:
                    return self._run_search(job, executor, data, t0)
                runs = job.spec.configs()
                labels = [l for l, _ in runs]
                cfgs = [c for _, c in runs]

                def on_shard(k: int, response: Dict[str, Any]) -> None:
                    assert_host_only(response,
                                     where="service stream event")
                    if job.t_first_shard is None:
                        job.t_first_shard = time.monotonic()
                        statsd.timing(
                            "service.job.time_to_first_shard_ms",
                            (job.t_first_shard - t0) * 1e3)
                    with job.cond:
                        job.shards_done += 1
                    job.append_event({
                        "event": "shard", "shard": k,
                        "runs": job.shards[k],
                        "result": response["result"],
                        "dispatch_counts": response["dispatch_counts"]})

                results, meta = executor.execute_with_meta(
                    labels, cfgs, data, stack=(job.stack == "auto"),
                    device=self.device, on_shard=on_shard, stop=job.stop)
                job.attempts_total = \
                    meta.get("launcher", {}).get("attempts_total", 0)
                merged = SweepResult(name=job.spec.name,
                                     records=records_from(labels, results))
                job.result_text = merged.to_json()
                if job.cache_mode != "off":
                    self.cache.put(job.key, job.result_text)
                job.finish("done")
                statsd.increment("service.jobs.completed")
            except SearchCancelled as e:
                job.finish("cancelled", error=str(e))
                statsd.increment("service.jobs.cancelled")
            except LauncherError as e:
                state = "cancelled" if job.stop.is_set() else "failed"
                job.finish(state, error=str(e))
                statsd.increment(f"service.jobs.{state}")
            except Exception as e:                     # noqa: BLE001
                job.finish("failed", error=f"{type(e).__name__}: {e}")
                statsd.increment("service.jobs.failed")
            finally:
                statsd.timing("service.job.wall_ms",
                              (time.monotonic() - t0) * 1e3)
                with self._lock:
                    self._running -= 1
                self._update_gauges()

    def _run_search(self, job: Job, executor: HostsExecutor,
                    data: Any, t0: float) -> None:
        """A Pareto-search job: the search drives the
        job's *fresh* executor rung by rung (fault-injection params
        stay job-local, exactly like plain sweeps), streaming one
        ``rung`` event per rung instead of per-shard payloads. The
        stored/cached bytes are the ``ParetoResult`` JSON — whose
        embedded ``frontier_result`` is bitwise a plain ``SweepSpec.run``
        of the frontier configs, so cache hits stay exact."""
        search = get_search(job.search)

        def on_rung(record: Dict[str, Any]) -> None:
            assert_host_only(record, where="service stream event")
            if job.t_first_shard is None:
                job.t_first_shard = time.monotonic()
            with job.cond:
                job.shards_done += 1      # rungs done, for status()
            job.append_event(dict(record, event="rung"))

        result = search.run(job.spec, data, stack=job.stack,
                            parallel=executor, on_rung=on_rung,
                            stop=job.stop, device=self.device)
        job.result_text = result.to_json()
        if job.cache_mode != "off":
            self.cache.put(job.key, job.result_text)
        job.finish("done")
        statsd.increment("service.jobs.completed")
        statsd.timing("service.search.wall_ms",
                      (time.monotonic() - t0) * 1e3)

    # -- queries ------------------------------------------------------------
    def job(self, job_id: str) -> Job:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise ServiceError(404, f"no job {job_id!r}")
        return job

    def cancel(self, job_id: str,
               cancel_token: Optional[str] = None) -> Dict[str, Any]:
        job = self.job(job_id)
        # constant-time compare; missing/non-string tokens fail the same
        # way as wrong ones, so a 403 leaks nothing about the token
        if not (isinstance(cancel_token, str)
                and secrets.compare_digest(cancel_token,
                                           job.cancel_token)):
            statsd.increment("service.cancel.denied")
            raise ServiceError(403, f"cancel of {job_id} requires the "
                                    f"cancel_token from its submit reply")
        job.stop.set()
        if job.state == "queued":
            # not yet picked up: the runner thread will fail fast on the
            # stop event before dispatching any shard
            pass
        return job.status()

    def result_text(self, job_id: str) -> str:
        job = self.job(job_id)
        if job.state != "done" or job.result_text is None:
            raise ServiceError(409, f"job {job_id} is {job.state}; "
                                    f"results exist only for done jobs")
        return job.result_text

    def result_page(self, job_id: str, page: int, per_page: int) -> str:
        if self.job(job_id).search:
            raise ServiceError(400, f"job {job_id} is a search; its "
                                    f"ParetoResult does not page — GET "
                                    f"the full result")
        full = SweepResult.from_json(self.result_text(job_id))
        try:
            return full.page(page, per_page).to_json(include_meta=True)
        except ValueError as e:
            raise ServiceError(400, str(e))

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            jobs = {"total": self._n_jobs, "queued": self._queued,
                    "running": self._running}
        return {"schema": SERVICE_SCHEMA, "statsd": statsd.snapshot(),
                "cache": self.cache.stats(), "jobs": jobs}

    def health(self) -> Dict[str, Any]:
        with self._lock:
            depth = self._queued + self._running
        return {"status": "ok", "queue_depth": depth,
                "backend": self.backend, "device": self.device}


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.0: streamed responses are delimited by connection close, so
    # the NDJSON stream needs no chunked framing and any stdlib client
    # reads it line by line until EOF
    protocol_version = "HTTP/1.0"

    @property
    def service(self) -> SweepService:
        return self.server.service          # type: ignore[attr-defined]

    def log_message(self, fmt, *args):      # quiet: statsd is the signal
        pass

    # -- helpers ------------------------------------------------------------
    def _send_json(self, obj: Any, status: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, text: str, status: int = 200,
                   ctype: str = "application/json") -> None:
        body = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body_json(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ServiceError(400, "missing request body")
        try:
            return json.loads(self.rfile.read(length))
        except json.JSONDecodeError as e:
            raise ServiceError(400, f"request body is not JSON: {e}")

    def _route(self) -> Tuple[str, List[str], Dict[str, List[str]]]:
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        return url.path, parts, parse_qs(url.query)

    def _qs_int(self, qs, name, default):
        try:
            return int(qs.get(name, [default])[0])
        except ValueError:
            raise ServiceError(400, f"query param {name} must be an int")

    # -- verbs --------------------------------------------------------------
    def do_POST(self):          # noqa: N802 (stdlib naming)
        path, parts, _ = self._route()
        try:
            if parts == ["v1", "jobs"]:
                with statsd.timed("service.http.submit_ms"):
                    return self._send_json(
                        self.service.submit(self._body_json()))
            if len(parts) == 4 and parts[:2] == ["v1", "jobs"] \
                    and parts[3] == "cancel":
                # lenient parse: an empty/malformed body means "no
                # token", which the service turns into a 403 (not a 400
                # — authorization, not framing, is what's missing)
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(length)) \
                        if length > 0 else {}
                except json.JSONDecodeError:
                    body = {}
                token = body.get("cancel_token") \
                    if isinstance(body, dict) else None
                return self._send_json(
                    self.service.cancel(parts[2], token))
            raise ServiceError(404, f"no POST route {path!r}")
        except ServiceError as e:
            return self._send_json({"error": e.detail}, status=e.status)
        except Exception as e:                         # noqa: BLE001
            return self._send_json(
                {"error": f"{type(e).__name__}: {e}"}, status=500)

    def do_GET(self):           # noqa: N802
        path, parts, qs = self._route()
        try:
            if parts == ["v1", "healthz"]:
                return self._send_json(self.service.health())
            if parts == ["v1", "metrics"]:
                return self._send_json(self.service.metrics())
            if len(parts) == 3 and parts[:2] == ["v1", "jobs"]:
                return self._send_json(
                    self.service.job(parts[2]).status())
            if len(parts) == 4 and parts[:2] == ["v1", "jobs"]:
                job_id, tail = parts[2], parts[3]
                if tail == "stream":
                    return self._stream(job_id, qs)
                if tail == "results":
                    if "page" in qs or "per_page" in qs:
                        page = self._qs_int(qs, "page", 0)
                        per = self._qs_int(qs, "per_page", 50)
                        return self._send_text(
                            self.service.result_page(job_id, page, per))
                    # full result: the stored bytes VERBATIM — this is
                    # the parity (and cache-exactness) surface
                    return self._send_text(
                        self.service.result_text(job_id))
            raise ServiceError(404, f"no GET route {path!r}")
        except ServiceError as e:
            return self._send_json({"error": e.detail}, status=e.status)
        except (BrokenPipeError, ConnectionResetError):
            pass                  # streaming client went away mid-write
        except Exception as e:                         # noqa: BLE001
            return self._send_json(
                {"error": f"{type(e).__name__}: {e}"}, status=500)

    # -- the NDJSON stream --------------------------------------------------
    def _stream(self, job_id: str, qs) -> None:
        job = self.service.job(job_id)
        cursor = self._qs_int(qs, "cursor", 0)
        max_events = self._qs_int(qs, "max_events", 0)   # 0 = unbounded
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()                # no length: close delimits
        statsd.increment("service.stream.connections")
        sent = 0
        try:
            while True:
                events = job.wait_events(cursor, timeout=5.0)
                if not events and job.terminal():
                    return       # cursor already past the terminal event
                for event in events:
                    self.wfile.write(
                        (json.dumps(event) + "\n").encode())
                    self.wfile.flush()
                    cursor = event["seq"] + 1
                    sent += 1
                    statsd.increment("service.stream.events")
                    if event["event"] in ("done", "error"):
                        return
                    if max_events and sent >= max_events:
                        return           # bounded response; client
                                         # reconnects with its cursor
        except (BrokenPipeError, ConnectionResetError):
            statsd.increment("service.stream.disconnects")


def make_server(host: str = "127.0.0.1", port: int = 0,
                service: Optional[SweepService] = None, **service_kw
                ) -> Tuple[ThreadingHTTPServer, SweepService]:
    """Bind a threading HTTP server around a :class:`SweepService`
    (``port=0`` picks a free port — tests and the parity gate use this).
    The caller drives ``serve_forever`` (usually on a daemon thread)."""
    service = service if service is not None else SweepService(**service_kw)
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.service = service                 # type: ignore[attr-defined]
    return httpd, service


def service_from_spec(spec: str) -> Tuple[ThreadingHTTPServer, SweepService]:
    """Build server+service from one nested-grammar spec string, e.g.::

        serve:port=8080;device=cuda;backend=hosts:channel=local,n=4;cache_dir=results/sweep_cache

    ``";"``-separated parameters with list continuation, so the embedded
    executor/channel specs nest without escaping (the same grammar as
    channel specs)."""
    name, params = parse_spec(spec, sep=";", merge_unkeyed=True)
    if name != "serve":
        raise ValueError(f"service spec must start with 'serve', got "
                         f"{spec!r}")
    cache_dir = params.pop("cache_dir", None)
    cache = ResultCache(directory=cache_dir) if cache_dir else None
    host = str(params.pop("host", "127.0.0.1"))
    port = int(params.pop("port", 0))
    return make_server(host=host, port=port, cache=cache, **params)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.service.server",
        description="Streaming sweep service")
    ap.add_argument("--spec", default=None,
                    help="full service spec, e.g. "
                         "'serve:port=8080;backend=hosts:channel=local,"
                         "n=4'")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--backend", default=DEFAULT_BACKEND)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where every job runs (default cuda; cpu runs "
                         "the port on the CPU)")
    args = ap.parse_args(argv)

    if args.spec:
        httpd, service = service_from_spec(args.spec)
    else:
        cache = (ResultCache(directory=args.cache_dir)
                 if args.cache_dir else None)
        httpd, service = make_server(host=args.host, port=args.port,
                                     backend=args.backend, cache=cache,
                                     device=args.device)
    host, port = httpd.server_address[:2]
    print(f"sweep service listening on {host}:{port} "
          f"(backend {service.backend}, device {service.device})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
