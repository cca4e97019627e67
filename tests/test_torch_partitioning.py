"""The port's partitioning rules (``repro_torch.sharding.partitioning``)
against the JAX package's, and the reference's own partitioning tests
(``tests/test_partitioning.py``'s pure cases, ``tests/test_sharding.py``,
``tests/test_hlo_parsing.py``'s ``_strip_axes``) run on the port.

Parity: for every architecture's parameter template and decode cache
template, under DEFAULT, MULTIPOD, FLEET and the weight-stationary decode
rules, on the pod1 (16 x 16) and pod2 (2 x 16 x 16) axis sizes, every
leaf's spec equals the reference's entry for entry (exact).
``to_placements``: on an 8-device host mesh, every rank's slice of a
DTensor laid out by a spec equals the slice JAX's
``NamedSharding(...).devices_indices_map`` gives the device at the same
mesh coordinate (exact), for specs resolved from logical axes by each
package's ``logical_to_pspec``: multi-axis entries, and dims the mesh
axes do not divide (replicated by the rule) included.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # deterministic shim, tests/_hypothesis_fallback.py
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.launch import specs as j_specs
from repro.models import build_model as j_build
from repro.sharding import partitioning as jp
from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import specs as t_specs
from repro_torch.models import build_model
from repro_torch.sharding import partitioning as tp
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES, FLEET_AXIS, FLEET_RULES, MULTIPOD_RULES, P,
    _strip_axes, dc_pspec, hint, logical_to_pspec, param_pspecs,
    param_shape_structs, template_bytes, use_compute_mesh,
)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


class FakeMesh:
    """Stand-in with just .shape (logical_to_pspec only uses that)."""
    def __init__(self, **axes):
        self.shape = dict(axes)


MESH = FakeMesh(data=16, model=16)
MESH3 = FakeMesh(pod=2, data=16, model=16)
MESHES = {"pod1": MESH, "pod2": MESH3}


def _leaves(tree, is_spec, prefix=""):
    """{path: leaf} of a nested dict (the port's trees)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if is_spec(v):
            out[prefix + k] = v
        else:
            out.update(_leaves(v, is_spec, f"{prefix}{k}/"))
    return out


def _j_specs(template, mesh, rules):
    specs = jp.param_pspecs(template, mesh, rules)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v)
            for path, v in flat}


def _t_specs(template, mesh, rules):
    return {k: tuple(v) for k, v in _leaves(
        param_pspecs(template, mesh, rules),
        lambda x: isinstance(x, tp.PartitionSpec)).items()}


def test_rule_tables_equal_the_reference():
    assert DEFAULT_RULES == jp.DEFAULT_RULES
    assert MULTIPOD_RULES == jp.MULTIPOD_RULES
    assert FLEET_RULES == jp.FLEET_RULES
    assert FLEET_AXIS == jp.FLEET_AXIS
    assert ALL_ARCHS == J_ARCHS


@pytest.mark.parametrize("mesh_kind", ["pod1", "pod2"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_cache_specs_equal_the_reference(arch, mesh_kind):
    mesh = MESHES[mesh_kind]
    tcfg, jcfg = get_config(arch), j_config(arch)
    t_model = build_model(tcfg, device="meta")
    j_model = j_build(jcfg)
    dec = INPUT_SHAPES["decode_32k"]
    rule_sets = {"default": DEFAULT_RULES, "multipod": MULTIPOD_RULES,
                 "fleet": FLEET_RULES,
                 "decode": t_specs.param_rules_for(mesh, dec, tcfg)}
    j_decode = j_specs.param_rules_for(mesh, J_SHAPES["decode_32k"], jcfg)
    assert rule_sets["decode"] == j_decode
    templates = [(t_model.template(), j_model.template())]
    if tcfg.supports_decode:
        templates.append((t_model.cache_template(8, 4096),
                          j_model.cache_template(8, 4096)))
    for name, rules in rule_sets.items():
        for tt, jt in templates:
            got, want = _t_specs(tt, mesh, rules), _j_specs(jt, mesh, rules)
            assert got == want, (arch, mesh_kind, name)


# ------------------------------------------- tests/test_partitioning.py
def test_fleet_rules_only_override_dc():
    assert FLEET_RULES["dc"] == FLEET_AXIS
    assert DEFAULT_RULES["dc"] is None
    assert {k: v for k, v in FLEET_RULES.items() if k != "dc"} == \
        {k: v for k, v in DEFAULT_RULES.items() if k != "dc"}


def test_dc_pspec_shards_leading_dim_only():
    assert dc_pspec(1) == P(FLEET_AXIS)
    assert dc_pspec(3) == P(FLEET_AXIS, None, None)


def test_logical_to_pspec_fleet_rules_divisible():
    spec = logical_to_pspec(("dc", None), (128, 55), FakeMesh(dc=8),
                            FLEET_RULES)
    assert spec == P("dc")            # trailing None trimmed


def test_logical_to_pspec_fleet_rules_non_divisible_replicates():
    spec = logical_to_pspec(("dc", None), (130, 55), FakeMesh(dc=8),
                            FLEET_RULES)
    assert spec == P()


def test_default_rules_keep_dc_replicated():
    mesh = FakeMesh(data=4, model=2, dc=8)
    spec = logical_to_pspec(("dc", "embed"), (128, 64), mesh, DEFAULT_RULES)
    assert spec == P(None, "data")


# ---------------------------------------------- tests/test_sharding.py
def test_divisible_dims_shard():
    spec = logical_to_pspec(("embed", "mlp"), (4096, 8192), MESH,
                            DEFAULT_RULES)
    assert spec == P("data", "model")


def test_non_divisible_replicates():
    spec = logical_to_pspec(("embed", "heads", "head_dim"), (3072, 24, 128),
                            MESH, DEFAULT_RULES)
    assert spec == P("data")


def test_axis_never_reused():
    spec = logical_to_pspec(("batch", "cache_len", "kv_heads", None),
                            (128, 32768, 16, 128), MESH, DEFAULT_RULES)
    assert spec == P("data", "model")


def test_batch_multi_pod():
    spec = logical_to_pspec(("batch", None), (256, 4096), MESH3,
                            MULTIPOD_RULES)
    assert spec == P(("pod", "data"))


@given(dim=st.integers(min_value=1, max_value=10**6))
@settings(max_examples=100, deadline=None)
def test_sharded_dims_always_divisible(dim):
    spec = logical_to_pspec(("mlp",), (dim,), MESH, DEFAULT_RULES)
    if spec and spec[0] is not None:
        assert dim % MESH.shape["model"] == 0


@given(shape=st.lists(st.sampled_from([1, 2, 7, 16, 24, 128, 256, 4096]),
                      min_size=1, max_size=4),
       axes=st.lists(st.sampled_from(
           [None, "batch", "embed", "heads", "mlp", "vocab", "experts"]),
           min_size=1, max_size=4))
@settings(max_examples=100, deadline=None)
def test_pspec_properties_and_parity(shape, axes):
    n = min(len(shape), len(axes))
    shape, axes = tuple(shape[:n]), tuple(axes[:n])
    spec = logical_to_pspec(axes, shape, MESH, DEFAULT_RULES)
    assert tuple(spec) == tuple(jp.logical_to_pspec(axes, shape, MESH,
                                                    DEFAULT_RULES))
    flat = [a for e in spec for a in tp.spec_axes(e)]
    assert len(flat) == len(set(flat))
    for dim, a in zip(shape, tuple(spec) + (None,) * 4):
        if a is not None:
            assert dim % np.prod([MESH.shape[x] for x in
                                  tp.spec_axes(a)]) == 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_template_consistency(arch):
    """Template, specs and meta structs are consistent, the byte count
    matches initialised parameters, and the meta structs allocate
    nothing."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    t = model.template()
    specs = _leaves(param_pspecs(t, MESH, DEFAULT_RULES),
                    lambda x: isinstance(x, tp.PartitionSpec))
    structs = _leaves(param_shape_structs(t, torch.float32),
                      lambda x: isinstance(x, torch.Tensor))
    assert specs.keys() == structs.keys()
    assert all(s.is_meta for s in structs.values())
    tmpl = dict(tp.flatten(t))
    assert all(tuple(structs[k].shape) == tmpl[k].shape for k in tmpl)
    params = tp.init_params(t, 0, torch.float32, "cpu")
    assert template_bytes(t, torch.float32) == sum(
        x.numel() * x.element_size() for x in params.values())


# ------------------------------------------- tests/test_hlo_parsing.py
def test_strip_axes():
    assert _strip_axes(("pod", "data"), {"pod"}) == "data"
    assert _strip_axes("pod", {"pod"}) is None
    assert _strip_axes("data", {"pod"}) == "data"
    assert _strip_axes(None, {"pod"}) is None
    assert _strip_axes(("pod", "data", "model"), {"pod"}) == ("data",
                                                              "model")
    for e in (("pod", "data"), "pod", "data", None, ("pod", "data", "model")):
        assert _strip_axes(e, {"pod"}) == jp._strip_axes(e, {"pod"})


# ------------------------------------------------------------- hint
def test_hint_is_a_no_op_without_a_mesh_or_on_a_plain_tensor():
    x = torch.randn(4, 8, 16)
    assert hint(x, ("batch", None, None)) is x
    with use_compute_mesh(MESH):
        assert hint(x, ("batch", None, None)) is x
    assert tp.current_mesh() is None


# ----------------------------------------------------- to_placements
# Each case: (mesh shape, axis names, tensor shape, logical axes, rules):
# the spec is each package's logical_to_pspec of the logical axes, so a
# dim the mesh axes do not divide is replicated by the rule (JAX refuses
# an uneven tile outright: its index map asserts even tiles).
PLACEMENT_CASES = [
    ((2, 4), ("data", "model"), (8, 12), ("batch", "mlp"), "default"),
    ((2, 4), ("data", "model"), (16, 6), ("experts_both", None), "default"),
    ((2, 4), ("data", "model"), (6, 10), ("batch", "mlp"), "default"),
    ((2, 4), ("data", "model"), (5, 8), ("batch", "heads"), "default"),
    ((2, 2, 2), ("pod", "data", "model"), (8, 6, 4),
     ("batch", None, "heads"), "multipod"),
    ((2, 2, 2), ("pod", "data", "model"), (4, 8), ("vocab", "batch"),
     "multipod"),
    ((2, 2, 2), ("pod", "data", "model"), (6, 8, 2), ("batch", "embed",
                                                      "mlp"), "multipod"),
    ((2, 2, 2), ("pod", "data", "model"), (8, 3), ("dc", None), "multipod"),
]

JAX_SCRIPT = r"""
import json, os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.sharding import partitioning as jp
rules = {"default": jp.DEFAULT_RULES, "multipod": jp.MULTIPOD_RULES}
out = []
for mesh_shape, names, shape, axes, rule in json.loads(sys.argv[1]):
    mesh = jax.make_mesh(tuple(mesh_shape), tuple(names))
    spec = jp.logical_to_pspec(axes, shape, mesh, rules[rule])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    coords = {int(d.id): c for c, d in np.ndenumerate(mesh.devices)}
    rows = {}
    for d, sl in idx.items():
        rows[json.dumps([int(c) for c in coords[int(d.id)]])] = [
            [s.start or 0, shape[i] if s.stop is None else s.stop]
            for i, s in enumerate(sl)]
    out.append({"spec": [list(e) if isinstance(e, tuple) else e
                         for e in spec], "rows": rows})
print(json.dumps(out))
"""

TORCH_SCRIPT = r"""
import json, sys
import torch
from repro_torch.launch.mesh import fake_world
from repro_torch.sharding import partitioning as tp
from torch.distributed.device_mesh import init_device_mesh
rules = {"default": tp.DEFAULT_RULES, "multipod": tp.MULTIPOD_RULES}
cases = json.loads(sys.argv[1])
out = [{"rows": {}} for _ in cases]
for rank in range(8):
    fake_world(8, rank=rank)
    for i, (mesh_shape, names, shape, axes, rule) in enumerate(cases):
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=tuple(names))
        spec = tp.logical_to_pspec(axes, shape, mesh, rules[rule])
        full = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
        local = tp.distribute(full, mesh, spec).to_local()
        out[i]["spec"] = [list(e) if isinstance(e, tuple) else e
                          for e in spec]
        out[i]["rows"][json.dumps(mesh.get_coordinate())] = \
            local.reshape(-1).tolist()
print(json.dumps(out))
"""


def _run(script, cases, extra_env=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", **(extra_env or {}))
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(cases)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_to_placements_gives_every_rank_jax_slice():
    want = _run(JAX_SCRIPT, PLACEMENT_CASES)
    got = _run(TORCH_SCRIPT, PLACEMENT_CASES)
    specs = [g["spec"] for g in got]
    assert specs == [w["spec"] for w in want]
    assert ["pod", "data"] in [e for sp in specs for e in sp]  # multi-axis
    assert specs[2] == ["data"] and specs[3] == [None, "model"]  # uneven
    for case, w, g in zip(PLACEMENT_CASES, want, got):
        shape = case[2]
        full = np.arange(np.prod(shape)).reshape(shape)
        assert w["rows"].keys() == g["rows"].keys(), case
        for coord, bounds in w["rows"].items():
            sl = tuple(slice(a, b) for a, b in bounds)
            assert full[sl].reshape(-1).tolist() == g["rows"][coord], \
                (case, coord)


def test_to_placements_refuses_an_entry_out_of_mesh_order():
    class Mesh2:
        mesh_dim_names = ("data", "model")
    with pytest.raises(ValueError, match="order"):
        tp.to_placements(P(("model", "data")), Mesh2())
