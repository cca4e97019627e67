"""The port's input specs and static validator (``repro_torch.launch.
specs``, ``repro_torch.launch.validate``) against the JAX package's, and
the reference's ``tests/test_launch_specs.py`` and
``tests/test_validate.py`` run on the port.

Parity (exact): ``validate`` equals the reference's record field for
field for every arch x shape x {pod1, pod2} at the reference's 16 GiB
(the reference's ``fits_16gb`` is the port's ``fits_hbm``); the input
specs (every parameter, batch and cache leaf: shape, dtype, spec) equal
the reference's ``ShapeDtypeStruct``s for every arch x shape on both
meshes (the reference's ``_sds`` made mesh-free for the comparison).
"""
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.launch import specs as j_specs
from repro.launch import validate as j_validate
from repro.models import build_model as j_build
from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import validate as t_validate
from repro_torch.launch.specs import (
    TensorSpec, _densify_spec, arch_for_shape, batch_specs, input_specs,
    opt_state_specs, param_rules_for, shape_supported,
)
from repro_torch.sharding.partitioning import P

torch.set_num_threads(1)

GIB16 = 16 * 2**30


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


MESH = FakeMesh(data=16, model=16)
MESHES = {"pod1": MESH, "pod2": FakeMesh(pod=2, data=16, model=16)}


# ------------------------------------------ tests/test_launch_specs.py
def test_long_500k_support_matrix():
    runs = {a for a in ALL_ARCHS
            if shape_supported(get_config(a), INPUT_SHAPES["long_500k"])[0]}
    assert runs == {"mamba2-1.3b", "recurrentgemma-9b", "llama3.2-3b"}
    for a in set(ALL_ARCHS) - runs:
        ok, reason = shape_supported(get_config(a), INPUT_SHAPES["long_500k"])
        assert not ok and "quadratic" in reason


def test_llama_long_context_variant():
    cfg = arch_for_shape(get_config("llama3.2-3b"), INPUT_SHAPES["long_500k"])
    assert cfg.sliding_window == 8192
    cfg4k = arch_for_shape(get_config("llama3.2-3b"),
                           INPUT_SHAPES["train_4k"])
    assert cfg4k.sliding_window == 0


def test_all_other_shapes_supported_everywhere():
    for a in ALL_ARCHS:
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert shape_supported(get_config(a), INPUT_SHAPES[s])[0]


def test_decode_rules_weight_stationary():
    r_train = param_rules_for(MESH, INPUT_SHAPES["train_4k"])
    r_dec = param_rules_for(MESH, INPUT_SHAPES["decode_32k"])
    assert r_train["embed"] == "data"
    assert r_dec["embed"] is None
    assert r_dec["experts"] == ("data", "model")
    r_base = param_rules_for(MESH, INPUT_SHAPES["decode_32k"],
                             weight_stationary_decode=False)
    assert r_base["embed"] == "data"


def test_vlm_seq_budget_includes_frontend():
    cfg = get_config("llava-next-mistral-7b")
    bs = batch_specs(cfg, INPUT_SHAPES["train_4k"], FakeMesh(data=1,
                                                             model=1))
    n_front = cfg.frontend.num_tokens
    assert bs["tokens"].shape == (256, 4096 - n_front)
    assert bs["frontend_embeds"].shape == (256, n_front, cfg.d_model)


def test_whisper_batch_includes_encoder():
    cfg = get_config("whisper-medium")
    bs = batch_specs(cfg, INPUT_SHAPES["prefill_32k"], FakeMesh(data=1,
                                                                model=1))
    assert bs["encoder_embeds"].shape == (32, 1500, 1024)


def test_scalars_stay_zero_dim():
    cfg = get_config("llama3.2-3b")
    dec = input_specs(cfg, INPUT_SHAPES["decode_32k"], MESH)
    assert dec["batch"]["pos"] == TensorSpec((), torch.int32)
    tr = input_specs(cfg, INPUT_SHAPES["train_4k"], MESH)
    assert tr["step"].shape == () and tr["opt_state"].count.shape == ()
    assert tr["opt_state"].mu["embed"].dtype == torch.float32
    assert tr["opt_state"].mu["embed"].spec == tr["params"]["embed"].spec
    assert tr["opt_state"].mu["embed"].meta().is_meta


# ---------------------------------------------- tests/test_validate.py
def test_densify_fills_free_axes():
    spec = _densify_spec(P(None, "data", None, None), (28, 3072, 24, 128),
                         MESH)
    assert spec == P(None, "data", None, "model")
    assert tuple(spec) == tuple(j_specs._densify_spec(
        j_specs.P(None, "data", None, None), (28, 3072, 24, 128), MESH))


def test_densify_no_free_axes():
    spec = _densify_spec(P(None, "data", "model"), (28, 3072, 8192), MESH)
    assert spec == P(None, "data", "model")


def test_zero1_moments_are_densified():
    cfg = get_config("llama3.2-3b")
    ps = input_specs(cfg, INPUT_SHAPES["train_4k"], MESH)["params"]
    opt = opt_state_specs(ps, MESH, zero1=True)
    s = ps["layers"]["attn"]["wq"]
    assert opt.mu["layers"]["attn"]["wq"].spec == _densify_spec(
        s.spec, s.shape, MESH)


def test_validator_deepseek_train_exceeds_hbm():
    r = t_validate.validate("deepseek-v3-671b", "train_4k",
                            hbm_bytes=GIB16)
    assert not r["fits_hbm"]
    r2 = t_validate.validate("deepseek-v3-671b", "decode_32k",
                             hbm_bytes=GIB16)
    assert r2["fits_hbm"]


def test_validator_all_decodes_fit():
    for a in ALL_ARCHS:
        r = t_validate.validate(a, "decode_32k", hbm_bytes=GIB16)
        if r["status"] == "ok":
            assert r["fits_hbm"], (a, r)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_validate_equals_the_reference(arch, multi_pod):
    for shape in INPUT_SHAPES:
        got = t_validate.validate(arch, shape, multi_pod, hbm_bytes=GIB16)
        want = j_validate.validate(arch, shape, multi_pod)
        if "fits_16gb" in want:
            want["fits_hbm"] = want.pop("fits_16gb")
            assert got.pop("hbm_gib") == 16.0
        assert got == want, (arch, shape, multi_pod)


def test_host_mesh_validates_on_the_card_memory():
    from repro_torch.models import build_model
    from repro_torch.sharding.partitioning import flatten, template_bytes
    t = build_model(get_config("llama3.2-3b"), device="meta").template()
    r = t_validate.validate("llama3.2-3b", "train_4k", mesh="host")
    n = len(list(flatten(t)))
    assert r["replicated_weight_leaves"] == f"{n}/{n}"
    assert r["hbm_gib"] == t_validate.HBM_BYTES / 2**30
    # bf16 weights and gradients, float32 moments: 6x the bf16 weights
    assert r["train_state_gib"] * 2**30 == 6 * template_bytes(
        t, torch.bfloat16)
    assert r["fits_hbm"]


# ------------------------------------------------ input specs parity
def _mesh_free_sds(shape, dtype, mesh, spec):
    return (tuple(shape), np.dtype(dtype).name, tuple(spec))


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, (TensorSpec, tuple)) and not isinstance(v, dict):
            out[prefix + k] = v
        else:
            out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _t_leaf(ts):
    return (tuple(ts.shape), str(ts.dtype).removeprefix("torch."),
            tuple(ts.spec))


@pytest.mark.parametrize("mesh_kind", ["pod1", "pod2"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_equal_the_reference(arch, mesh_kind, monkeypatch):
    monkeypatch.setattr(j_specs, "_sds", _mesh_free_sds)
    mesh = MESHES[mesh_kind]
    for name, shape in INPUT_SHAPES.items():
        if not shape_supported(get_config(arch), shape)[0]:
            continue
        got = input_specs(get_config(arch), shape, mesh)
        jcfg = j_specs.arch_for_shape(j_config(arch), J_SHAPES[name])
        jm = j_build(jcfg)
        want = {"params": j_specs.param_specs(
                    jm, mesh, j_specs.param_rules_for(
                        mesh, J_SHAPES[name], jcfg)),
                "batch": j_specs.batch_specs(jcfg, J_SHAPES[name], mesh)}
        if shape.kind == "decode":
            want["cache"] = j_specs.cache_specs(jm, J_SHAPES[name], mesh)
            want["batch"]["pos"] = ((), "int32", ())
        for part, tree in want.items():
            w = {k: v for k, v in _flat(tree).items()}
            g = {k: _t_leaf(v) for k, v in _flat(got[part]).items()}
            assert g == w, (arch, name, mesh_kind, part)
        if shape.kind == "train":
            mu = {k: _t_leaf(v) for k, v in
                  _flat(got["opt_state"].mu).items()}
            assert mu == {k: (s, "float32", p) for k, (s, _, p) in
                          _flat(want["params"]).items()}
