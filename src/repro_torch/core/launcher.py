"""Multi-host sweep launcher with shard-level fault tolerance.

Port of ``repro.core.launcher``: the same deterministic shard payloads go
to *independent host processes*, on this machine or others, and a
launched run merges **bitwise identical** (JSON-identical `SweepResult`)
to the sequential run, clean or under worker loss.

Three layers:

* **Wire format.** A shard request is pure JSON: the shard's labels,
  `ScenarioConfig` dicts, the dataset (numpy buffers base64-encoded, so
  float64 bits survive any transport exactly), the stack flag and the
  device the worker runs the shard on (``"device"``, the one key the
  reference's request lacks; a request without it runs on ``"cuda"``). A
  shard response is the shard's `SweepResult` JSON plus its dispatch
  counts — produced by the same shared shard runner
  (:func:`repro_torch.core.parallel.run_shard_payload`) the spawn pool
  uses, so the payload schema cannot drift between transports. Responses on a
  stream are framed by a sentinel line (:data:`RESULT_SENTINEL`), making
  the protocol robust to stray library prints on stdout.

* **Channels** (`HostChannel`): pluggable shard transports, addressed by
  the nested spec grammar of :mod:`repro_torch.core.registry`
  (`";"`-separated params, unkeyed segments continue the previous value —
  so
  ``ssh:hosts=a;b;c`` is both well-formed and readable):

  - ``local`` — one fresh ``python -m repro_torch.core.launcher --worker``
    subprocess per shard attempt; `n` interchangeable slots. The
    CI-testable reference channel.
  - ``ssh:hosts=a;b;c`` — the same worker over ``ssh host ...`` with
    stdin/stdout JSON framing; one slot per remote host.
  - ``slurm:array=N`` — batch mode: stages per-shard request files +
    an ``#SBATCH --array`` job script whose tasks run the file-mode
    worker (``--input``/``--output``), then collects result files.
    ``submit=bash`` simulates the array locally (the CI path),
    ``submit=sbatch`` really submits, ``submit=none`` only stages.

* **Fault tolerance** (`HostsExecutor`): worker loss is a first-class
  event, not an abort. Each shard gets up to ``retries + 1`` attempts
  with exponential backoff; a failed/crashed/timed-out attempt
  re-dispatches to a *different surviving slot* when one exists, waiting
  for it while it is busy (slots with fewer failures are preferred). Because a shard is a deterministic
  function of its partition — same configs, same within-group order, same
  seeds — a retried shard reproduces exactly the bytes the first attempt
  would have produced, which is the whole determinism argument for
  bitwise parity under re-dispatch. Every attempt (slot, status, error,
  elapsed) is logged into ``SweepResult.meta["launcher"]`` — a
  side-channel field excluded from serialization and equality, so the
  parity contract is untouched.

Held against the reference in tests/test_torch_launcher.py (clean, one
injected SIGKILL, the slurm file flow) and on the card by chip_smoke.py.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.parallel import (SweepExecutor, assert_host_only,
                                       merge_shard_payloads, partition_runs,
                                       run_shard_payload)
from repro_torch.core.registry import (format_spec, parse_spec,
                                       register_factory)
from repro_torch.core.scenario import ScenarioConfig
from repro_torch.data.synthetic_covtype import Dataset

PAYLOAD_SCHEMA = 1
RESULT_SENTINEL = "==REPRO_SHARD_RESULT=="
# set on a worker's environment by the fault-injection path: the worker
# SIGKILLs itself mid-shard (request parsed, dataset decoded, no result
# written) — the hardest failure shape a channel can see
INJECT_ENV = "REPRO_LAUNCHER_INJECT"


# ---------------------------------------------------------------------------
# wire format: dataset codec, requests, framing
# ---------------------------------------------------------------------------

def encode_dataset(data: Dataset) -> Dict[str, Any]:
    """Dataset -> JSON-safe dict. Buffers go as base64 of the raw bytes,
    so the decoded arrays are bit-for-bit the originals on any host with
    the same endianness (dtype strings pin byte order explicitly)."""
    out: Dict[str, Any] = {"kind": "arrays", "fields": {}}
    for name, arr in zip(Dataset._fields, data):
        a = np.ascontiguousarray(arr)
        out["fields"][name] = {
            "dtype": a.dtype.str,          # includes byte order, e.g. '<f8'
            "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii"),
        }
    return out


def decode_dataset(payload: Dict[str, Any]) -> Dataset:
    if payload.get("kind") != "arrays":
        raise ValueError(f"unknown dataset payload kind "
                         f"{payload.get('kind')!r}")
    fields = []
    for name in Dataset._fields:
        f = payload["fields"][name]
        a = np.frombuffer(base64.b64decode(f["b64"]),
                          dtype=np.dtype(f["dtype"]))
        fields.append(a.reshape(f["shape"]).copy())   # writable, owned
    return Dataset(*fields)


def build_request(shard: int, labels: Sequence[str],
                  cfgs: Sequence[ScenarioConfig], data: Any,
                  stack: bool, device="cuda") -> Dict[str, Any]:
    """One shard's worker request: pure JSON, transport-agnostic.
    ``data`` may be a :class:`Dataset` or an already-encoded payload dict
    — the executor encodes once and shares it across all shards. Less its
    ``"device"``, the request is the reference's."""
    request = {
        "schema": PAYLOAD_SCHEMA,
        "shard": int(shard),
        "labels": list(labels),
        "cfgs": [dataclasses.asdict(c) for c in cfgs],
        "stack": bool(stack),
        "data": data if isinstance(data, dict) else encode_dataset(data),
        "device": str(device),
    }
    assert_host_only(request, where="shard request")
    return request


def run_request(request: Dict[str, Any]) -> Dict[str, Any]:
    """Worker side: execute one shard request through the shared shard
    runner, on the request's ``"device"`` (``"cuda"`` when it has none),
    and return the response payload."""
    if request.get("schema") != PAYLOAD_SCHEMA:
        raise ValueError(f"unsupported shard-request schema "
                         f"{request.get('schema')!r} (this worker speaks "
                         f"{PAYLOAD_SCHEMA})")
    cfgs = [ScenarioConfig(**c) for c in request["cfgs"]]
    data = decode_dataset(request["data"])
    if os.environ.get(INJECT_ENV) == "sigkill":
        # fault-injection hook (inject_kill): die mid-shard with no exit
        # handlers and no response — what a powered-off edge node looks
        # like
        import signal
        sys.stderr.write("launcher worker: injected SIGKILL\n")
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)
    payload, counts = run_shard_payload(request["labels"], cfgs, data,
                                        request["stack"],
                                        request.get("device", "cuda"))
    return {"schema": PAYLOAD_SCHEMA, "shard": request["shard"],
            "result": payload, "dispatch_counts": counts}


def frame_response(response: Dict[str, Any]) -> str:
    """Stream framing: sentinel line, then the response JSON on one line.
    Anything a library printed to stdout before the sentinel is ignored
    by :func:`parse_response`."""
    return f"\n{RESULT_SENTINEL}\n{json.dumps(response)}\n"


def parse_response(stream_text: str) -> Dict[str, Any]:
    lines = stream_text.splitlines()
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].strip() == RESULT_SENTINEL:
            body = "\n".join(lines[i + 1:]).strip()
            try:
                response = json.loads(body)
            except json.JSONDecodeError as e:
                raise ChannelError("frame", f"unparseable response after "
                                   f"sentinel: {e}") from e
            if response.get("schema") != PAYLOAD_SCHEMA:
                raise ChannelError("frame", f"response schema "
                                   f"{response.get('schema')!r} != "
                                   f"{PAYLOAD_SCHEMA}")
            return response
    raise ChannelError("frame", f"no result sentinel in worker output "
                       f"({len(stream_text)} bytes)")


def _worker_env(extra_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Subprocess environment: inherit, ensure src/ is importable (the
    worker runs ``-m repro_torch.core.launcher`` from an arbitrary cwd)."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ)
    prev = env.get("PYTHONPATH", "")
    if src not in prev.split(os.pathsep):
        env["PYTHONPATH"] = f"{src}{os.pathsep}{prev}" if prev else src
    env.update(extra_env or {})
    return env


def _stats():
    """The process-wide statsd client (repro_torch.service.statsd),
    resolved lazily: the metrics module is stdlib-only and imports nothing
    from repro_torch.core, so the retry path can emit fleet-health
    counters/timers (shard attempts, failures by kind, retries, attempt
    latency) without the core layer depending on the service layer at
    import time."""
    from repro_torch.service.statsd import statsd
    return statsd


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------

class ChannelError(RuntimeError):
    """One failed shard attempt. ``kind`` classifies it for the attempt
    log: 'crash' (nonzero exit / vanished worker), 'timeout', 'frame'
    (unparseable response), 'submit' (batch submission failed)."""

    def __init__(self, kind: str, detail: str):
        super().__init__(f"[{kind}] {detail}")
        self.kind = kind
        self.detail = detail


class HostChannel:
    """One way to run shard payloads on some set of hosts.

    Interactive channels (``batch = False``) expose ``slots()`` —
    identifiers of independent workers — and a synchronous
    :meth:`run` per attempt. Batch channels (``batch = True``,
    slurm) take whole request batches via :meth:`run_batch` and return
    per-request responses or :class:`ChannelError`\\ s.
    """

    batch = False

    def slots(self) -> List[str]:
        raise NotImplementedError

    def run(self, slot: str, request: Dict[str, Any], *,
            timeout: Optional[float] = None,
            extra_env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def run_batch(self, requests: Sequence[Dict[str, Any]], *,
                  timeout: Optional[float] = None
                  ) -> List[Any]:       # Dict | ChannelError per request
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


def _communicate(cmd: List[str], request: Dict[str, Any], *,
                 timeout: Optional[float], extra_env: Optional[Dict[str, str]],
                 where: str) -> Dict[str, Any]:
    """Shared subprocess attempt: request JSON on stdin, framed response
    on stdout; crash/timeout/frame failures become :class:`ChannelError`."""
    import subprocess

    try:
        proc = subprocess.run(cmd, input=json.dumps(request),
                              capture_output=True, text=True,
                              timeout=timeout, env=_worker_env(extra_env))
    except subprocess.TimeoutExpired:
        raise ChannelError("timeout",
                           f"worker on {where} exceeded {timeout}s")
    except OSError as e:
        raise ChannelError("crash", f"could not spawn worker on {where}: "
                           f"{e}")
    if proc.returncode != 0:
        raise ChannelError(
            "crash", f"worker on {where} exited {proc.returncode}; stderr "
            f"tail: {proc.stderr[-800:]!r}")
    return parse_response(proc.stdout)


class InlineChannel(HostChannel):
    """``inline`` / ``inline:n=K``: run shard requests *in this process*
    through the same :func:`run_request` a worker would run — no spawn, no
    import, no fresh CUDA context. The sweep service's default backend: a
    long-running server already paid import, context and kernel build
    once, so per-shard subprocess cost would dominate every small job.

    Attempts are serialized by a module-wide lock: the shared shard runner
    snapshots the *global* dispatch counter per shard
    (:func:`repro_torch.core.parallel.run_shard_payload` resets then reads
    it),
    so two in-process shards may never interleave. Streaming still works —
    shards complete one by one and stream as they land; the slots only
    bound how many jobs queue on the lock. Fault injection is *simulated*
    (a scripted :class:`ChannelError`, never a real SIGKILL — that would
    kill the server): retry-path tests run cheaply, while the real-kill
    gate keeps using the ``local`` channel."""

    _RUN_LOCK = threading.Lock()

    def __init__(self, n: int = 1):
        if n < 1:
            raise ValueError(f"inline channel needs n >= 1, got {n}")
        self.n = n

    def slots(self) -> List[str]:
        return [f"inline/{i}" for i in range(self.n)]

    def run(self, slot, request, *, timeout=None, extra_env=None):
        if (extra_env or {}).get(INJECT_ENV):
            raise ChannelError("crash", f"inline worker on {slot}: "
                               f"injected fault (simulated; inline never "
                               f"SIGKILLs its own process)")
        with InlineChannel._RUN_LOCK:
            return run_request(request)

    def describe(self) -> str:
        return format_spec("inline", {"n": self.n}, sep=";")


class LocalChannel(HostChannel):
    """``local`` / ``local:n=K``: one fresh subprocess per shard attempt
    on this machine — K interchangeable slots bound the concurrency. Every
    attempt is a brand-new interpreter, so the CUDA context, EvalCache and
    dispatch counters are worker-local by construction (same isolation as
    the spawn pool)."""

    def __init__(self, n: int = 2):
        if n < 1:
            raise ValueError(f"local channel needs n >= 1, got {n}")
        self.n = n

    def slots(self) -> List[str]:
        return [f"local/{i}" for i in range(self.n)]

    def run(self, slot, request, *, timeout=None, extra_env=None):
        cmd = [sys.executable, "-m", "repro_torch.core.launcher", "--worker"]
        return _communicate(cmd, request, timeout=timeout,
                            extra_env=extra_env, where=slot)

    def describe(self) -> str:
        return format_spec("local", {"n": self.n}, sep=";")


class SSHChannel(HostChannel):
    """``ssh:hosts=a;b;c``: the stdin/stdout worker over ssh, one slot
    per remote host. Assumes the repo is importable on the remote (same
    checkout path or an installed package); ``python`` and ``opts``
    parameterize the remote interpreter and extra ssh options."""

    def __init__(self, hosts: str = "", python: str = "python3",
                 opts: str = ""):
        self.hosts = [h.strip() for h in str(hosts).split(";") if h.strip()]
        if not self.hosts:
            raise ValueError("ssh channel needs hosts=a;b;c")
        self.python = python
        self.opts = [o for o in str(opts).split() if o]

    def slots(self) -> List[str]:
        return [f"ssh/{h}" for h in self.hosts]

    def command(self, slot: str,
                extra_env: Optional[Dict[str, str]] = None) -> List[str]:
        """The exact argv for one attempt (unit-testable without a
        cluster). Injection env rides the remote command line — the local
        environment does not cross ssh."""
        host = slot.split("/", 1)[1]
        remote_env = "".join(f"{k}={v} " for k, v in
                             (extra_env or {}).items())
        return (["ssh", "-o", "BatchMode=yes", *self.opts, host,
                 f"{remote_env}{self.python} -m repro_torch.core.launcher "
                 f"--worker"])

    def run(self, slot, request, *, timeout=None, extra_env=None):
        # extra_env is encoded into the remote command; the local
        # subprocess env is untouched
        return _communicate(self.command(slot, extra_env), request,
                            timeout=timeout, extra_env=None, where=slot)

    def describe(self) -> str:
        return format_spec("ssh", {"hosts": ";".join(self.hosts)}, sep=";")


class SlurmChannel(HostChannel):
    """``slurm:array=N``: batch dispatch through a SLURM array job.

    :meth:`run_batch` *stages* the batch — per-shard request files plus an
    ``#SBATCH --array=0-(S-1)%N`` script whose task i runs the file-mode
    worker (``--input shard_i.json --output result_i.json``) — then
    submits per ``submit=``:

    - ``sbatch``: really submit, poll for result files until ``timeout``;
    - ``bash``: simulate the array locally by running the script once per
      task id with ``SLURM_ARRAY_TASK_ID`` set (the CI path — identical
      script, identical file flow, no scheduler);
    - ``none``: stage only and report every shard as pending (the
      operator submits by hand and re-collects).

    Missing/unreadable results surface as per-shard 'crash'
    :class:`ChannelError`\\ s, so the executor's retry loop re-stages just
    the failed shards as a follow-up array.
    """

    batch = True

    def __init__(self, array: int = 0, dir: str = "results/slurm_shards",
                 submit: str = "sbatch", python: str = "python3",
                 poll_s: float = 5.0, max_wait: float = 3600.0):
        if submit not in ("sbatch", "bash", "none"):
            raise ValueError(f"slurm submit must be sbatch|bash|none, "
                             f"got {submit!r}")
        self.array = int(array)          # max simultaneous tasks; 0 = all
        self.dir = dir
        self.submit = submit
        self.python = python
        self.poll_s = float(poll_s)
        # poll budget when the executor passes no timeout: a task that
        # dies without writing its result file must become a 'crash'
        # ChannelError (and a retry), never an infinite poll loop
        self.max_wait = float(max_wait)
        self._batch_no = 0

    def _fresh_batch_dir(self) -> str:
        """A directory no previous batch has used — result files are
        collected from here, so a stale ``result_*.json`` left by an
        earlier run (this channel instance or a prior one pointing at the
        same ``dir``) must never be readable as a fresh response."""
        while True:
            self._batch_no += 1
            batch_dir = os.path.join(self.dir,
                                     f"batch_{self._batch_no:03d}")
            try:
                os.makedirs(batch_dir, exist_ok=False)
                return batch_dir
            except FileExistsError:
                continue

    def slots(self) -> List[str]:
        return ["slurm/array"]

    def stage(self, requests: Sequence[Dict[str, Any]], batch_dir: str
              ) -> str:
        """Write request files + the array-job script; returns the script
        path."""
        os.makedirs(batch_dir, exist_ok=True)
        for i, req in enumerate(requests):
            with open(os.path.join(batch_dir, f"shard_{i:04d}.json"),
                      "w") as f:
                json.dump(req, f)
        n = len(requests)
        throttle = f"%{self.array}" if 0 < self.array < n else ""
        py = self.python if self.submit != "bash" else sys.executable
        script = os.path.join(batch_dir, "launch_array.sh")
        with open(script, "w") as f:
            f.write(
                "#!/usr/bin/env bash\n"
                "#SBATCH --job-name=repro-sweep-shards\n"
                f"#SBATCH --array=0-{n - 1}{throttle}\n"
                f"#SBATCH --output={batch_dir}/slurm_%a.log\n"
                "set -euo pipefail\n"
                f"i=$(printf '%04d' \"$SLURM_ARRAY_TASK_ID\")\n"
                f"{py} -m repro_torch.core.launcher "
                f"--input {batch_dir}/shard_$i.json "
                f"--output {batch_dir}/result_$i.json\n")
        os.chmod(script, 0o755)
        return script

    def run_batch(self, requests, *, timeout=None):
        import subprocess

        batch_dir = self._fresh_batch_dir()
        script = self.stage(requests, batch_dir)
        n = len(requests)
        if self.submit == "bash":
            for i in range(n):
                subprocess.run(["bash", script], timeout=timeout,
                               env=_worker_env(
                                   {"SLURM_ARRAY_TASK_ID": str(i)}),
                               capture_output=True)
        elif self.submit == "sbatch":
            sub = subprocess.run(["sbatch", script], capture_output=True,
                                 text=True)
            if sub.returncode != 0:
                err = ChannelError("submit", f"sbatch failed: "
                                   f"{sub.stderr[-400:]!r}")
                return [err] * n
            deadline = time.monotonic() + (timeout if timeout
                                           else self.max_wait)
            while any(not os.path.exists(
                    os.path.join(batch_dir, f"result_{i:04d}.json"))
                    for i in range(n)):
                if time.monotonic() > deadline:
                    break
                time.sleep(self.poll_s)
        # submit == "none": stage only — collection below reports pending
        outs: List[Any] = []
        for i in range(n):
            path = os.path.join(batch_dir, f"result_{i:04d}.json")
            if not os.path.exists(path):
                outs.append(ChannelError(
                    "crash", f"no result file {path} (task missing, "
                    f"killed, or not yet submitted)"))
                continue
            try:
                with open(path) as f:
                    response = json.load(f)
                if response.get("schema") != PAYLOAD_SCHEMA:
                    raise ValueError(f"schema {response.get('schema')!r}")
                outs.append(response)
            except (ValueError, OSError) as e:
                outs.append(ChannelError("frame", f"bad result file "
                                         f"{path}: {e}"))
        return outs

    def describe(self) -> str:
        return format_spec("slurm", {"array": self.array,
                                     "submit": self.submit}, sep=";")


CHANNELS: Dict[str, Any] = {
    "inline": InlineChannel,
    "local": LocalChannel,
    "ssh": SSHChannel,
    "slurm": SlurmChannel,
}


def register_channel(name: str, factory: Any) -> None:
    register_factory(CHANNELS, name, factory, "host channel")


def get_channel(spec: str, *, default_slots: Optional[int] = None
                ) -> HostChannel:
    """Resolve a channel spec (nested grammar: ``";"``-separated params,
    list continuation — ``"local"``, ``"local:n=4"``,
    ``"ssh:hosts=a;b;c"``, ``"slurm:array=8;submit=bash"``). A trailing
    ``":"`` on a bare name is tolerated (``"local:"``). ``default_slots``
    seeds the local channel's slot count when the spec doesn't."""
    name, params = parse_spec(str(spec).rstrip(":"), sep=";",
                              merge_unkeyed=True)
    factory = CHANNELS.get(name)
    if factory is None:
        raise KeyError(f"no host channel registered for {spec!r}; known: "
                       f"{sorted(CHANNELS)}")
    if name == "local" and "n" not in params and default_slots:
        params["n"] = default_slots
    try:
        return factory(**params)
    except TypeError as e:
        raise KeyError(f"bad parameters for host channel {spec!r}: {e}") \
            from e


# ---------------------------------------------------------------------------
# slot pool: prefer surviving slots, avoid a shard's own failed slots
# ---------------------------------------------------------------------------

class _SlotPool:
    def __init__(self, slots: Sequence[str]):
        self._order = {s: i for i, s in enumerate(slots)}
        self._free = list(slots)
        self._failures = {s: 0 for s in slots}
        self._cv = threading.Condition()

    def acquire(self, avoid: Sequence[str] = ()) -> str:
        """Block for a free slot. Preference order: slots this shard has
        not failed on, then fewest recorded failures (surviving slots
        first), then stable index. While some slot outside ``avoid``
        exists, a retry waits for one of them, so it lands on a
        different worker than the one that failed it (the reference takes
        a failed slot when it is the only free one)."""
        others = set(self._order) - set(avoid)
        with self._cv:
            while not (others & set(self._free) if others
                       else self._free):
                self._cv.wait()
            s = min(self._free, key=lambda x: (x in avoid,
                                               self._failures[x],
                                               self._order[x]))
            self._free.remove(s)
            return s

    def release(self, slot: str, *, failed: bool) -> None:
        with self._cv:
            if failed:
                self._failures[slot] += 1
            self._free.append(slot)
            self._cv.notify_all()    # waiters may each want another slot


# ---------------------------------------------------------------------------
# the hosts executor
# ---------------------------------------------------------------------------

class LauncherError(RuntimeError):
    """A shard exhausted its retry budget. Carries the full attempt log
    so the operator sees every slot/failure that was tried."""

    def __init__(self, msg: str, attempts: List[dict]):
        super().__init__(msg)
        self.attempts = attempts


class HostsExecutor(SweepExecutor):
    """``parallel="hosts:channel=...,n=K,retries=R"``: partition with the
    shared stack-key partitioner, dispatch each shard to an independent
    host process through the channel, retry failures on surviving slots,
    merge order-stably — bitwise parity with ``parallel="none"`` by the
    same argument as the spawn pool, because shards are deterministic
    functions of the partition and retries re-run the identical payload.

    Parameters (spec grammar): ``channel`` — a nested channel spec or a
    ready :class:`HostChannel` instance (tests inject fakes this way);
    ``n`` — shard count, defaulting to the channel's slot count;
    ``retries`` — extra attempts per shard; ``backoff`` — base seconds
    for exponential backoff (``backoff * 2**(attempt-1)``); ``timeout`` —
    per-attempt seconds; ``inject_kill`` — fault injection: the shard
    index whose *first* attempt gets ``REPRO_LAUNCHER_INJECT=sigkill``
    (the fault gate's hook).
    """

    def __init__(self, channel: Any = "local", n: Optional[int] = None,
                 retries: int = 2, backoff: float = 0.05,
                 timeout: Optional[float] = None,
                 inject_kill: Optional[int] = None):
        if n is not None and n < 1:
            raise ValueError(f"hosts executor needs n >= 1, got {n}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if backoff < 0:
            raise ValueError(f"backoff must be >= 0, got {backoff}")
        self.channel = channel
        self.n = n
        self.retries = retries
        self.backoff = backoff
        self.timeout = timeout
        self.inject_kill = inject_kill

    def _resolve_channel(self) -> HostChannel:
        if isinstance(self.channel, HostChannel):
            return self.channel
        return get_channel(str(self.channel), default_slots=self.n)

    def execute(self, labels, cfgs, data, *, stack, device="cuda"):
        return self.execute_with_meta(labels, cfgs, data, stack=stack,
                                      device=device)[0]

    def execute_with_meta(self, labels, cfgs, data, *, stack,
                          device="cuda", on_shard=None, stop=None):
        """``on_shard(shard_index, response_dict)`` — when given — fires as
        each shard's response lands (from the dispatching thread), which is
        what the sweep service streams to its clients: the merge becomes
        incremental instead of barriered. ``stop`` is an optional
        :class:`threading.Event`; once set, no *new* shard attempt starts
        and the run fails fast with a ``cancelled`` attempt log (job
        cancellation). Neither affects the merged values — both are pure
        control-plane hooks. Every request carries ``device``: each
        worker runs its shard there."""
        channel = self._resolve_channel()
        n = self.n if self.n is not None else max(1, len(channel.slots()))
        shards = [s for s in partition_runs(cfgs, n) if s]
        encoded = encode_dataset(data)      # once; identical for all shards
        requests = [build_request(k, [labels[i] for i in idxs],
                                  [cfgs[i] for i in idxs], encoded, stack,
                                  device)
                    for k, idxs in enumerate(shards)]
        if not shards:
            return [], {"launcher": {"channel": channel.describe(),
                                     "n_shards": 0, "shards": []}}
        logs: List[Dict[str, Any]] = [
            {"shard": k, "runs": list(idxs), "attempts": []}
            for k, idxs in enumerate(shards)]
        if channel.batch:
            outs = self._dispatch_batch(channel, requests, logs,
                                        on_shard=on_shard, stop=stop)
        else:
            outs = self._dispatch_slots(channel, requests, logs,
                                        on_shard=on_shard, stop=stop)
        results = merge_shard_payloads(
            len(cfgs), shards,
            [(r["result"], r["dispatch_counts"]) for r in outs])
        meta = {"launcher": {
            "channel": channel.describe(),
            "n_shards": len(shards),
            "retries": self.retries,
            "attempts_total": sum(len(l["attempts"]) for l in logs),
            "shards": logs,
        }}
        return results, meta

    # -- interactive channels (inline / local / ssh) ------------------------
    def _dispatch_slots(self, channel, requests, logs, *,
                        on_shard=None, stop=None):
        pool = _SlotPool(channel.slots())
        stats = _stats()

        def run_one(k: int) -> Dict[str, Any]:
            failed_on: List[str] = []
            for attempt in range(1, self.retries + 2):
                if stop is not None and stop.is_set():
                    logs[k]["attempts"].append(
                        {"attempt": attempt, "slot": None,
                         "status": "cancelled"})
                    raise LauncherError(f"shard {k} cancelled before "
                                        f"attempt {attempt}",
                                        logs[k]["attempts"])
                slot = pool.acquire(avoid=failed_on)
                extra_env = ({INJECT_ENV: "sigkill"}
                             if (self.inject_kill == k and attempt == 1)
                             else None)
                t0 = time.monotonic()
                try:
                    response = channel.run(slot, requests[k],
                                           timeout=self.timeout,
                                           extra_env=extra_env)
                    self._check(response, k)
                except ChannelError as e:
                    pool.release(slot, failed=True)
                    failed_on.append(slot)
                    elapsed = time.monotonic() - t0
                    stats.increment("launcher.shard.attempts")
                    stats.increment("launcher.shard.failures",
                                    tags={"kind": e.kind})
                    stats.timing("launcher.shard.attempt_ms",
                                 elapsed * 1e3)
                    logs[k]["attempts"].append({
                        "attempt": attempt, "slot": slot,
                        "status": e.kind, "error": e.detail,
                        "elapsed_s": round(elapsed, 3)})
                    if attempt > self.retries:
                        raise LauncherError(
                            f"shard {k} failed {attempt} attempt(s), "
                            f"retry budget {self.retries} exhausted; "
                            f"last: {e}", logs[k]["attempts"]) from e
                    stats.increment("launcher.shard.retries")
                    time.sleep(self.backoff * (2 ** (attempt - 1)))
                    continue
                pool.release(slot, failed=False)
                elapsed = time.monotonic() - t0
                stats.increment("launcher.shard.attempts")
                stats.increment("launcher.shard.ok")
                stats.timing("launcher.shard.attempt_ms", elapsed * 1e3)
                logs[k]["attempts"].append({
                    "attempt": attempt, "slot": slot, "status": "ok",
                    "elapsed_s": round(elapsed, 3)})
                if on_shard is not None:
                    on_shard(k, response)
                return response
            raise AssertionError("unreachable")

        with ThreadPoolExecutor(
                max_workers=min(len(requests),
                                len(channel.slots()))) as tpool:
            return list(tpool.map(run_one, range(len(requests))))

    # -- batch channels (slurm) ---------------------------------------------
    def _dispatch_batch(self, channel, requests, logs, *,
                        on_shard=None, stop=None):
        stats = _stats()
        outs: List[Any] = [None] * len(requests)
        pending = list(range(len(requests)))
        for attempt in range(1, self.retries + 2):
            if stop is not None and stop.is_set():
                for k in pending:
                    logs[k]["attempts"].append(
                        {"attempt": attempt, "slot": None,
                         "status": "cancelled"})
                raise LauncherError(
                    f"shard(s) {pending} cancelled before batch attempt "
                    f"{attempt}",
                    [a for k in pending for a in logs[k]["attempts"]])
            batch = channel.run_batch([requests[k] for k in pending],
                                      timeout=self.timeout)
            still: List[int] = []
            for k, result in zip(pending, batch):
                entry = {"attempt": attempt, "slot": "slurm/array"}
                stats.increment("launcher.shard.attempts")
                if isinstance(result, ChannelError):
                    entry.update(status=result.kind, error=result.detail)
                    stats.increment("launcher.shard.failures",
                                    tags={"kind": result.kind})
                    still.append(k)
                else:
                    try:
                        self._check(result, k)
                        outs[k] = result
                        entry.update(status="ok")
                        stats.increment("launcher.shard.ok")
                        if on_shard is not None:
                            on_shard(k, result)
                    except ChannelError as e:
                        entry.update(status=e.kind, error=e.detail)
                        stats.increment("launcher.shard.failures",
                                        tags={"kind": e.kind})
                        still.append(k)
                logs[k]["attempts"].append(entry)
            pending = still
            if not pending:
                return outs
            if attempt <= self.retries:
                stats.increment("launcher.shard.retries", len(pending))
                time.sleep(self.backoff * (2 ** (attempt - 1)))
        raise LauncherError(
            f"shard(s) {pending} failed after {self.retries + 1} batch "
            f"attempt(s)",
            [a for k in pending for a in logs[k]["attempts"]])

    @staticmethod
    def _check(response: Dict[str, Any], shard: int) -> None:
        if response.get("shard") != shard:
            raise ChannelError("frame", f"response for shard "
                               f"{response.get('shard')!r}, expected "
                               f"{shard}")
        if "result" not in response or "dispatch_counts" not in response:
            raise ChannelError("frame", "response missing result/"
                               "dispatch_counts")


# ---------------------------------------------------------------------------
# worker entry points: `python -m repro_torch.core.launcher --worker` (stream)
# and `--input/--output` (file mode, SLURM array tasks)
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.core.launcher",
        description="Shard worker for the multi-host sweep launcher")
    ap.add_argument("--worker", action="store_true",
                    help="stream mode: shard request JSON on stdin, "
                         "framed response on stdout")
    ap.add_argument("--input", help="file mode: read the shard request "
                                    "from this JSON file")
    ap.add_argument("--output", help="file mode: write the response here")
    args = ap.parse_args(argv)

    if args.input or args.output:
        if not (args.input and args.output):
            ap.error("file mode needs both --input and --output")
        with open(args.input) as f:
            request = json.load(f)
        response = run_request(request)
        tmp = args.output + ".tmp"
        with open(tmp, "w") as f:
            json.dump(response, f)
        os.replace(tmp, args.output)     # atomic: collectors never see
        return 0                         # a half-written result
    if args.worker:
        request = json.loads(sys.stdin.read())
        response = run_request(request)
        sys.stdout.write(frame_response(response))
        sys.stdout.flush()
        return 0
    ap.error("pick a mode: --worker or --input/--output")
    return 2


if __name__ == "__main__":
    sys.exit(main())
