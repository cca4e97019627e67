"""The port's multi-host launcher (``repro_torch.core.launcher``) against
the JAX package's: the wire codec gives the reference's bytes, a request
is the reference's plus its ``"device"``, the channels run the port's
worker (``python -m repro_torch.core.launcher``), and the ``inline``,
``local`` (clean and with shard 0's first worker SIGKILLed) and ``slurm``
(``submit=bash``) channels on the CPU give JSON byte-equal to the port's
sequential run, whose ledgers equal the reference's exactly and whose F1
is within the port's bound. Worker processes are fresh interpreters, so
the grid stays tiny (2 windows, 2500 rows)."""
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from _torch_sweep_ref import (DATA, assert_matches_reference,
                              port_smoke_json, smoke_spec)
from repro.core import launcher as j_launch
from repro_torch.core import launcher as t_launch
from repro_torch.core.experiment import SweepResult, records_from
from repro_torch.core.launcher import (ChannelError, HostChannel,
                                       HostsExecutor, LauncherError,
                                       SlurmChannel, SSHChannel)
from repro_torch.core.parallel import (get_executor, partition_runs,
                                       run_shard_payload)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _runs():
    runs = smoke_spec().configs()
    return [lbl for lbl, _ in runs], [c for _, c in runs]


def test_dataset_codec_is_the_reference_bytes_and_round_trips():
    enc = t_launch.encode_dataset(DATA)
    assert json.dumps(enc) == json.dumps(j_launch.encode_dataset(DATA))
    back = t_launch.decode_dataset(json.loads(json.dumps(enc)))
    for a, b in zip(DATA, back):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_request_is_the_reference_request_plus_its_device(device):
    labels, cfgs = _runs()
    got = t_launch.build_request(1, labels[:2], cfgs[:2], DATA, True,
                                 device=device)
    assert got.pop("device") == device
    assert got == j_launch.build_request(1, labels[:2], cfgs[:2], DATA,
                                         True)
    assert t_launch.build_request(0, labels, cfgs, DATA,
                                  False)["device"] == "cuda"


def test_request_without_a_device_runs_on_the_card(monkeypatch):
    labels, cfgs = _runs()
    request = t_launch.build_request(0, labels[:1], cfgs[:1], DATA, True)
    del request["device"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_launch.run_request(request)
    with pytest.raises(ValueError, match="schema"):
        t_launch.run_request({"schema": 999})


def test_framing_and_channel_grammar():
    response = {"schema": t_launch.PAYLOAD_SCHEMA, "shard": 3,
                "result": "{}", "dispatch_counts": {}}
    noisy = "stray library print\n" + t_launch.frame_response(response)
    assert t_launch.parse_response(noisy) == response
    assert t_launch.RESULT_SENTINEL == j_launch.RESULT_SENTINEL
    with pytest.raises(ChannelError, match="sentinel"):
        t_launch.parse_response("no frame here")
    assert sorted(t_launch.CHANNELS) == sorted(j_launch.CHANNELS)
    assert t_launch.get_channel("local:n=3").slots() \
        == [f"local/{i}" for i in range(3)]
    ex = get_executor("hosts:channel=local,n=4,retries=2")
    assert isinstance(ex, HostsExecutor) and (ex.n, ex.retries) == (4, 2)
    cmd = SSHChannel(hosts="a;b").command("ssh/b")
    assert cmd[-1] == "python3 -m repro_torch.core.launcher --worker"
    env = t_launch._worker_env()
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(t_launch.__file__))))
    assert src in env["PYTHONPATH"].split(os.pathsep)


@pytest.mark.parametrize("parallel", [
    "hosts:channel=inline,n=2",
    "hosts:channel=local,n=2",
    "hosts:channel=local,n=2,retries=1,backoff=0.01,inject_kill=0"])
def test_hosts_backend_is_byte_equal_to_the_sequential_run(parallel):
    ref = port_smoke_json()
    got = smoke_spec().run(DATA, parallel=parallel, device="cpu")
    assert got.to_json() == ref
    assert_matches_reference(got)
    log = got.meta["launcher"]["shards"]
    want0 = ["crash", "ok"] if "inject_kill=0" in parallel else ["ok"]
    assert [a["status"] for a in log[0]["attempts"]] == want0
    assert [a["status"] for a in log[1]["attempts"]] == ["ok"]
    if "inject_kill" in parallel:      # the retry ran on the other slot
        assert log[0]["attempts"][1]["slot"] != log[0]["attempts"][0]["slot"]


def test_slurm_bash_simulation_is_byte_equal(tmp_path):
    labels, cfgs = _runs()
    ch = SlurmChannel(array=2, dir=str(tmp_path), submit="bash")
    ex = HostsExecutor(channel=ch, n=2, retries=0, backoff=0.0)
    results, meta = ex.execute_with_meta(labels, cfgs, DATA, stack=True,
                                         device="cpu")
    got = SweepResult(name="smoke", records=records_from(labels, results))
    assert got.to_json() == port_smoke_json()
    script = (tmp_path / "batch_001" / "launch_array.sh").read_text()
    assert "-m repro_torch.core.launcher --input" in script
    staged = json.loads((tmp_path / "batch_001" /
                         "shard_0000.json").read_text())
    assert staged["device"] == "cpu"
    assert all(a["status"] == "ok"
               for s in meta["launcher"]["shards"] for a in s["attempts"])


def test_file_mode_worker_runs_the_request_on_its_device(tmp_path):
    labels, cfgs = _runs()
    req = t_launch.build_request(0, labels[:2], cfgs[:2], DATA, True,
                                 device="cpu")
    (tmp_path / "in.json").write_text(json.dumps(req))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.launcher", "--input",
         str(tmp_path / "in.json"), "--output", str(tmp_path / "out.json")],
        env=t_launch._worker_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    response = json.loads((tmp_path / "out.json").read_text())
    payload, counts = run_shard_payload(labels[:2], cfgs[:2], DATA, True,
                                        device="cpu")
    assert (response["result"], response["dispatch_counts"]) \
        == (payload, counts)


class FakeChannel(HostChannel):
    """Replays canned shard responses, failing scripted (shard, attempt)
    pairs: the retry, slot and merge machinery without subprocesses."""

    def __init__(self, canned, fail_plan, n_slots=3):
        self.canned, self.fail_plan = canned, dict(fail_plan)
        self.n_slots, self._attempts = n_slots, {}
        self._lock = threading.Lock()
        self.devices = []

    def slots(self):
        return [f"fake/{i}" for i in range(self.n_slots)]

    def run(self, slot, request, *, timeout=None, extra_env=None):
        shard = request["shard"]
        with self._lock:
            attempt = self._attempts[shard] = \
                self._attempts.get(shard, 0) + 1
            self.devices.append(request["device"])
        kind = self.fail_plan.get((shard, attempt))
        if kind is not None:
            raise ChannelError(kind, f"scripted {kind}")
        return self.canned[shard]


def _canned():
    labels, cfgs = _runs()
    shards = [s for s in partition_runs(cfgs, 2) if s]
    out = []
    for k, idxs in enumerate(shards):
        payload, counts = run_shard_payload(
            [labels[i] for i in idxs], [cfgs[i] for i in idxs], DATA, True,
            device="cpu")
        out.append({"schema": t_launch.PAYLOAD_SCHEMA, "shard": k,
                    "result": payload, "dispatch_counts": counts})
    return labels, cfgs, out


@pytest.mark.parametrize("kind", ["crash", "timeout", "frame"])
def test_retries_merge_bitwise_and_exhaustion_raises(kind):
    labels, cfgs, canned = _canned()
    ch = FakeChannel(canned, {(0, 1): kind, (1, 1): kind, (1, 2): kind},
                     n_slots=4)
    ex = HostsExecutor(channel=ch, n=2, retries=2, backoff=0.0)
    results, meta = ex.execute_with_meta(labels, cfgs, DATA, stack=True,
                                         device="cpu")
    got = SweepResult(name="smoke", records=records_from(labels, results))
    assert got.to_json() == port_smoke_json()
    assert set(ch.devices) == {"cpu"}
    log = meta["launcher"]["shards"]
    assert [a["status"] for a in log[1]["attempts"]] == [kind, kind, "ok"]
    assert meta["launcher"]["attempts_total"] == 5
    ch = FakeChannel(canned, {(1, a): kind for a in (1, 2)})
    with pytest.raises(LauncherError, match="retry budget 1 exhausted"):
        HostsExecutor(channel=ch, n=2, retries=1, backoff=0.0
                      ).execute_with_meta(labels, cfgs, DATA, stack=True,
                                          device="cpu")
