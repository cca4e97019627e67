"""The port's sweep service (``repro_torch.service``) against the JAX
package's, on the CPU: the dataset digest and the spec hash are the
reference's, the cache key carries the device type (card and CPU bytes
never share a key), and a live server on ``127.0.0.1:0`` (``inline``
backend, ``device="cpu"``) serves a streamed sweep byte-equal to the
port's sequential run — on a cache hit, across stream reconnects
(``max_events=1``) and for a Pareto search — and cancels a job only with
its token; ``/v1/metrics`` shows the cache hit."""
import json
import subprocess
import sys
import threading

import pytest
import torch

from _torch_sweep_ref import (DATA, assert_matches_reference,
                              port_smoke_json, smoke_spec)
from repro.core import experiment as j_exp
from repro.core import launcher as j_launch
from repro.service import cache as j_cache
from repro_torch.core import experiment as t_exp
from repro_torch.core import launcher as t_launch
from repro_torch.core import pareto as t_par
from repro_torch.service import cache as t_cache
from repro_torch.service.client import ClientError, ServiceClient
from repro_torch.service.server import (ServiceError, SweepService,
                                        make_server, service_from_spec)
from repro_torch.service.statsd import statsd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def endpoint():
    httpd, service = make_server(backend="hosts:channel=inline,n=2",
                                 device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield ServiceClient(httpd.server_address[:2]), service
    httpd.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("preset,kw", [("smoke", dict(windows=2, n_seeds=2)),
                                       ("pareto", {}),
                                       ("paper_tables",
                                        dict(windows=30, n_seeds=1))])
def test_digest_and_spec_hash_are_the_reference_ones(preset, kw):
    assert t_cache.dataset_digest(t_launch.encode_dataset(DATA)) \
        == j_cache.dataset_digest(j_launch.encode_dataset(DATA))
    assert t_exp.get_preset(preset, **kw).canonical_hash() \
        == j_exp.get_preset(preset, **kw).canonical_hash()


def test_cache_key_carries_the_device_type():
    key = dict(spec_hash="s", data_digest="d", stack="auto")
    cuda = t_cache.cache_key(**key, device="cuda")
    assert cuda != t_cache.cache_key(**key, device="cpu")
    assert cuda == t_cache.cache_key(**key, device="cuda:1") \
        == t_cache.cache_key(**key)
    assert cuda != t_cache.cache_key(**key, device="cuda", search="x")
    assert t_cache.cache_key(**key, device="cpu") \
        != t_cache.cache_key(**dict(key, stack="off"), device="cpu")


def test_result_cache_round_trips_bytes_and_spills(tmp_path):
    cache = t_cache.ResultCache(directory=str(tmp_path), max_entries=1)
    cache.put("a", "A")
    cache.put("b", "B")         # evicts "a" from memory; the disk keeps it
    assert len(cache) == 1
    assert cache.get("a") == "A" and cache.get("b") == "B"
    assert t_cache.ResultCache(directory=str(tmp_path)).get("a") == "A"
    assert cache.get("missing") is None


def test_streamed_run_and_cache_hit_are_byte_equal(endpoint):
    client, service = endpoint
    ref = port_smoke_json()
    hits = statsd.counter("service.cache.hit")
    first = client.run(smoke_spec(), DATA)
    assert first.to_json() == ref
    assert first.meta["service"]["cached"] is False
    assert_matches_reference(first)
    again = client.run(smoke_spec(), DATA)
    assert again.meta["service"]["cached"] is True
    assert again.to_json() == ref
    assert client.result_text(again.meta["service"]["job"]) == ref
    metrics = client.metrics()
    assert metrics["statsd"]["counters"]["service.cache.hit"] >= hits + 1
    assert metrics["cache"]["entries"] >= 1
    assert client.health()["device"] == "cpu" == service.device
    # the key is the CPU's: a card request of the same sweep misses
    assert first.meta["service"]["key"] == t_cache.cache_key(
        smoke_spec().canonical_hash(),
        t_cache.dataset_digest(t_launch.encode_dataset(DATA)), "auto",
        device="cpu")


def test_stream_resumes_across_bounded_connections(endpoint):
    client, _ = endpoint
    conns = statsd.counter("service.stream.connections")
    out = client.run(smoke_spec(), DATA, cache="bypass",
                     max_events_per_conn=1)
    assert out.to_json() == port_smoke_json()
    assert statsd.counter("service.stream.connections") - conns >= 3
    job = out.meta["service"]["job"]
    events = list(client.stream_events(job, cursor=1))
    assert events[0]["seq"] == 1 and events[-1]["event"] == "done"


def test_search_over_the_service_is_the_in_process_search(endpoint):
    client, _ = endpoint
    spec = t_exp.get_preset("pareto", windows=4, n_seeds=1)
    rungs = []
    got = client.search(spec, DATA, "halving:rungs=2,keep=0.5",
                        on_rung=rungs.append)
    want = t_par.get_search("halving:rungs=2,keep=0.5").run(
        spec, DATA, device="cpu")
    assert got.to_json() == want.to_json()
    assert [r["rung"] for r in rungs] == [0, 1]


class _GateChannel(t_launch.HostChannel):
    """The first attempt blocks on an event, so a job is observable
    mid-flight; later attempts run inline."""
    started = threading.Event()
    release = threading.Event()

    def __init__(self, n: int = 1):
        self.n = n
        self._taken = threading.Lock()

    def slots(self):
        return [f"gate/{i}" for i in range(self.n)]

    def run(self, slot, request, *, timeout=None, extra_env=None):
        if self._taken.acquire(blocking=False):
            _GateChannel.started.set()
            if not _GateChannel.release.wait(60):
                raise t_launch.ChannelError("timeout", "gate never opened")
        return t_launch.run_request(request)


def test_cancel_needs_its_token_and_stops_the_job(endpoint, monkeypatch):
    client, _ = endpoint
    monkeypatch.setitem(t_launch.CHANNELS, "gatetest", _GateChannel)
    sub = client.submit(smoke_spec(), DATA, cache="off",
                        backend="hosts:channel=gatetest,n=2")
    assert sub["n_shards"] == 2
    assert _GateChannel.started.wait(60)
    with pytest.raises(ClientError) as err:
        client.cancel(sub["job"], "not-the-token")
    assert err.value.status == 403
    client.cancel(sub["job"], sub["cancel_token"])
    _GateChannel.release.set()
    events = list(client.stream_events(sub["job"]))
    assert (events[-1]["event"], events[-1]["state"]) \
        == ("error", "cancelled")
    with pytest.raises(ClientError) as err:
        client.result_text(sub["job"])
    assert err.value.status == 409


def test_service_device_is_fixed_at_start_up(monkeypatch, tmp_path):
    with pytest.raises(ServiceError):
        SweepService(backend="processes:n=2", device="cpu")
    httpd, service = service_from_spec(
        f"serve:port=0;device=cpu;backend=hosts:channel=inline,n=1;"
        f"cache_dir={tmp_path}")
    assert service.device == "cpu" and service.cache.directory
    httpd.server_close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SweepService()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_server(backend="hosts:channel=inline,n=1")


def test_statsd_imports_neither_the_engines_nor_cuda():
    code = ("import sys, json\n"
            "from repro_torch.service import statsd\n"
            "import torch\n"
            "print(json.dumps([sorted(m for m in sys.modules if m.startswith("
            "'repro_torch.core')), torch.cuda.is_initialized()]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(t_launch._worker_env()))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == [[], False]
