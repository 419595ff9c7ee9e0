"""The sharding slice's rules on the CPU, held against the reference, with
no processes: ``param_logical_specs``, ``resolve_spec`` /
``tree_shardings`` (params and Adam state) on abstract meshes against the
reference's on ``jax.sharding.AbstractMesh``, ``data_spec``,
``decode_state_specs`` on shape-only state trees (``jax.eval_shape`` on
the reference, meta tensors in the port), ``input_specs``,
``_model_flops``, the activation-sharding policy and ``Mesh``.  Specs are
equal entry for entry; there is no tolerance."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import optimizer as ref_opt  # noqa: E402
from repro.distributed import sharding as ref_sh  # noqa: E402
from repro.launch.specs import input_specs as ref_input_specs  # noqa: E402
from repro.models import act_sharding as ref_acts  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import optimizer as opt  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.dryrun import _model_flops  # noqa: E402
from repro_torch.launch.mesh import Mesh, current_mesh  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import act_sharding as acts  # noqa: E402
from repro_torch.models.attention import _attn_shard_mode  # noqa: E402
from repro_torch.models.model import tree_flatten  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
# one config per family for the decode state
FAMILY_ARCHS = ("smollm_360m", "phi3_5_moe_42b", "mamba2_370m",
                "jamba_1_5_large_398b", "seamless_m4t_large_v2")


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), Mesh.abstract(shape, names)


def _port_model(arch):
    return Model(configs.get_config(arch), device="cpu")


@pytest.fixture(scope="module")
def ref_shapes():
    """Per arch: the reference's model and its params as ShapeDtypeStructs
    at full size (no allocation)."""
    out = {}

    def get(arch):
        if arch not in out:
            model = RefModel(ref_configs.get_config(arch))
            out[arch] = model, jax.eval_shape(
                lambda k: model.init_params(k, jnp.float32),
                jax.random.PRNGKey(0))
        return out[arch]
    return get


def _assert_same_specs(ref_tree, got_tree, mesh):
    ref_leaves, ref_def = jax.tree.flatten(ref_tree)
    got = tree_flatten(got_tree)[0]
    assert len(ref_leaves) == len(got)
    for r, g in zip(ref_leaves, got):
        assert g.spec == r.spec, (g.spec, r.spec)
        assert g.placements == sh.placements(r.spec, mesh)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_logical_specs_match_reference(arch):
    ref = RefModel(ref_configs.get_config(arch)).param_logical_specs()
    got = _port_model(arch).param_logical_specs()
    ref_leaves = jax.tree.leaves(ref, is_leaf=lambda x: isinstance(x, tuple))
    assert tree_flatten(got)[0] == ref_leaves
    shapes = _port_model(arch).param_shapes()
    assert all(t.device.type == "meta" for t in tree_flatten(shapes)[0])
    assert [len(t.shape) for t in tree_flatten(shapes)[0]] == \
        [len(x) for x in ref_leaves]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_tree_shardings_match_reference(ref_shapes, arch, mesh_name):
    """Params, then Adam's f32 and int8 state, at full size."""
    ref_mesh, mesh = _meshes(mesh_name)
    ref_model, ref_p = ref_shapes(arch)
    model = _port_model(arch)
    ref_logical = ref_model.param_logical_specs()
    logical = model.param_logical_specs()
    p = model.param_shapes()
    _assert_same_specs(ref_sh.tree_shardings(ref_p, ref_logical, ref_mesh),
                       sh.tree_shardings(p, logical, mesh), mesh)
    for dt in ("f32", "int8"):
        ref_adam = ref_opt.Adam(ref_opt.AdamConfig(state_dtype=dt))
        adam = opt.Adam(opt.AdamConfig(state_dtype=dt))
        _assert_same_specs(
            ref_sh.tree_shardings(jax.eval_shape(ref_adam.init, ref_p),
                                  ref_adam.state_logical_specs(ref_logical),
                                  ref_mesh),
            sh.tree_shardings(adam.init(p), adam.state_logical_specs(logical),
                              mesh), mesh)


def test_resolve_spec_rules_and_placements():
    """The reference's own cases (tests/test_distributed.py:169-192) and
    the placements of a spec over two FSDP axes."""
    m1 = Mesh.abstract((16, 16), ("data", "model"))
    m2 = Mesh.abstract((2, 16, 16), ("pod", "data", "model"))
    assert sh.resolve_spec((1024, 4096), ("embed", "ff"), m1) == \
        jax.sharding.PartitionSpec("data", "model")
    assert sh.resolve_spec((64, 1024, 32, 128),
                           ("layers", "embed", "heads", "head_dim"),
                           m1)[2] == "model"
    spec = sh.resolve_spec((960, 15, 64), ("embed", "heads", "head_dim"), m1)
    assert spec[1] is None and spec[2] == "model"
    spec = sh.resolve_spec((8192, 22016), ("embed", "ff"), m2)
    assert spec == (("pod", "data"), "model")
    assert sh.resolve_spec((3,), ("ssm_heads",), m1) == \
        jax.sharding.PartitionSpec(None)
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements(spec, m2) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(sh.P(None, None), m1) == (Replicate(), Replicate())
    import pickle
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert type(pickle.loads(pickle.dumps(spec))) is sh.PartitionSpec


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_data_spec_matches_reference(mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    for ndim in (1, 2, 3):
        for b in (1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 64, 256, 512, 1000):
            assert sh.data_spec(mesh, ndim, b) == \
                ref_sh.data_spec(ref_mesh, ndim, b), (ndim, b)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_state_specs_match_reference(arch, kv_quant):
    """Full-size configs, batch 16 (16 divides it, 2 x 16 does not: on the
    pod mesh the batch falls back to "data"), 64 positions; the encdec
    state over 16 frames of each utterance."""
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    B, L = 16, 64
    ref_model = RefModel(ref_cfg)
    model = Model(cfg, backend="torch", device="meta")
    kw, ref_kw = {}, {}
    if cfg.family == "encdec":
        ref_kw = dict(
            params=jax.eval_shape(
                lambda k: ref_model.init_params(k, jnp.float32),
                jax.random.PRNGKey(0)),
            enc_embeds=jax.ShapeDtypeStruct((B, 16, cfg.d_model),
                                            jnp.float32))
        kw = dict(params=model.param_shapes(),
                  enc_embeds=torch.empty((B, 16, cfg.d_model),
                                         device="meta"))
    ref_state = jax.eval_shape(
        lambda p, e: ref_model.init_decode_state(
            B, L, params=p, enc_embeds=e, kv_quant=kv_quant),
        ref_kw.get("params"), ref_kw.get("enc_embeds"))
    state = model.init_decode_state(B, L, kv_quant=kv_quant, **kw)
    assert sorted(state) == sorted(ref_state)
    for name in MESHES:
        ref_mesh, mesh = _meshes(name)
        ref = ref_sh.decode_state_specs(ref_cfg, ref_state, ref_mesh)
        got = sh.decode_state_specs(cfg, state, mesh)
        for key in ref:
            assert got[key].spec == ref[key].spec, (name, key)
            if key != "index":
                assert tuple(state[key].shape) == ref_state[key].shape


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("shape_name", list(configs.SHAPES))
def test_input_specs_match_reference(arch, shape_name):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    ok, _ = configs.shape_applicable(cfg, shape)
    if not ok:      # as tests/test_launch.py:82-84: no input for the cell
        assert not ref_configs.shape_applicable(
            ref_cfg, ref_configs.SHAPES[shape_name])[0]
        return
    ref = ref_input_specs(ref_cfg, ref_configs.SHAPES[shape_name])
    got = input_specs(cfg, shape)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == r.shape
        assert str(got[k].dtype).removeprefix("torch.") == str(r.dtype)


@pytest.fixture(scope="module")
def ref_model_flops():
    """The reference's ``_model_flops``: its module sets XLA_FLAGS when
    imported, so the JAX backend is started first and the flag put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import _model_flops as f
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return f


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_match_reference(ref_model_flops, arch):
    for name, shape in configs.SHAPES.items():
        assert _model_flops(configs.get_config(arch), shape) == \
            ref_model_flops(ref_configs.get_config(arch),
                            ref_configs.SHAPES[name])


# ------------------------------------------------- activation-sharding policy
@pytest.fixture
def clean_policies():
    acts.clear_policy()
    ref_acts.clear_policy()
    yield
    acts.clear_policy()
    ref_acts.clear_policy()


def test_noop_without_policy(clean_policies):
    x = torch.ones(4, 8)
    assert acts.constrain_batch(x) is x


def test_divisibility_skip(clean_policies):
    acts.set_policy(("data",), {"data": 16, "model": 16})
    x = torch.ones(5, 8)
    assert acts.constrain_batch(x) is x


def test_fallback_to_inner_axis(clean_policies):
    acts.set_policy(("pod", "data"), {"pod": 2, "data": 16, "model": 16})
    assert acts._batch_axes_for(32) == ("pod", "data")
    assert acts._batch_axes_for(16) == ("data",)
    assert acts._batch_axes_for(7) is None


def test_model_axis_size(clean_policies):
    assert acts.model_axis_size() == 1
    acts.set_policy(("data",), {"data": 16, "model": 8})
    assert acts.model_axis_size() == 8


def test_constrain_spec_map_skips_indivisible(clean_policies):
    acts.set_policy(("data",), {"data": 4, "model": 4})
    x = torch.arange(32.0).reshape(4, 8)
    y = acts.constrain(x, {0: "batch", 1: "model"})
    assert y is x
    tree = {"a": x, "b": {"c": torch.zeros(())}}
    assert acts.constrain_tree_batch(tree) is tree


def test_policy_context_manager(clean_policies):
    with acts.policy(("data",), {"data": 2}):
        assert acts._batch_axes_for(4) == ("data",)
    assert acts._batch_axes_for(4) is None


def test_attn_shard_mode(clean_policies):
    acts.set_policy(("data",), {"data": 16, "model": 16})
    assert _attn_shard_mode(96) == "heads"      # command-r
    assert _attn_shard_mode(15) == "seq"        # smollm
    assert _attn_shard_mode(24) == "seq"        # starcoder2
    acts.clear_policy()
    assert _attn_shard_mode(15) == "none"


def test_policy_matches_reference(clean_policies, monkeypatch):
    """Every policy function against the reference's over each mesh and
    the ablation hook."""
    from repro.models.attention import _attn_shard_mode as ref_mode
    for name in MESHES:
        for hook in ("0", "1"):
            monkeypatch.setenv("REPRO_NO_ACT_SHARDING", hook)
            ref_mesh, mesh = _meshes(name)
            ref_acts.policy_from_mesh(ref_mesh)
            acts.policy_from_mesh(mesh)
            assert acts._POLICY == ref_acts._POLICY
            assert acts.model_axis_size() == ref_acts.model_axis_size()
            for n in (1, 2, 7, 15, 16, 24, 32, 96, 512):
                assert acts._batch_axes_for(n) == ref_acts._batch_axes_for(n)
                assert _attn_shard_mode(n) == ref_mode(n)


def test_forward_unchanged_under_a_policy(clean_policies):
    """The policy of a 4 x 1 mesh changes no forward value (the port's
    constraints are the identity)."""
    cfg = configs.get_config("smollm_360m").reduced()
    model = Model(cfg, torch.float32, q_chunk=16, ssd_chunk=8,
                  loss_chunk=16, remat=False, backend="torch", device="cpu")
    params = model.init_params(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 32))
    base = model.forward(params, toks)
    acts.policy_from_mesh(Mesh.abstract((4, 1), ("data", "model")))
    assert torch.equal(model.forward(params, toks), base)


# ----------------------------------------------------------------------- mesh
def test_abstract_mesh_and_the_ambient_mesh():
    m = Mesh.abstract((2, 16, 16), ("pod", "data", "model"))
    ref = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert m.axis_names == ref.axis_names
    assert list(m.shape.items()) == list(ref.shape.items())
    assert m.size == 512 and not m.live and m.device_mesh is None
    with pytest.raises(ValueError, match="abstract"):
        m.group("data")
    with pytest.raises(ValueError, match="length"):
        Mesh.abstract((2, 2), ("data",))
    assert current_mesh() is None
    with m:
        inner = Mesh.abstract((1, 1), ("data", "model"))
        with inner:
            assert current_mesh() is inner
        assert current_mesh() is m
    assert current_mesh() is None
