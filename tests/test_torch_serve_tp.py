"""The sharded serving step (``repro_torch.launch.serve_step.ServeStep``:
``Model.prefill`` and ``decode_step`` on a live mesh) on the CPU over
gloo, held against the reference's single-device ``Model.prefill`` and
``decode_step`` and against the mesh-less step.

One spawn of four ranks (``tests/torch_ranks.py``'s ``serve_ranks``)
builds a (2, 2) and a (1, 4) mesh and runs every case of
``torch_ranks.SERVE_CASES`` on both: every family's ``.reduced()`` in f32
on ``backend="cuda"`` (the flash kernel's plain version on the rank's
heads), the 3-head dense config ("seq" attention on the torch engine,
its cache split over head_dim), the hybrid of 2 SSD heads (at (1, 4) the
whole block on every rank with its conv window split over d_inner), and
the int8 cache of every attention family.  Meanwhile this process
computes, from the same numpy weights and tokens, the reference's jitted
prefill and, from the mesh-less port's prefill state, its teacher-forced
decode steps.

Tolerances (``tests/tp_checks.py``'s f32 bounds): the prefill cell's
last logits within 1e-5 of the largest |logit| of the reference's; the
decode step's prefill logits within 1e-5 of the mesh-less step's (which
reads its cache, bf16 or int8, as stored); each decode step's logits
within 1e-3 of the reference's; each rank's state shards against
``shard_tensor`` of the mesh-less state: f32 leaves within 1e-5 of the
largest |entry|, bf16 leaves within one bf16 step of each entry, int8
values within one step and their scales within 1e-5.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tp_checks  # noqa: E402
import torch_ranks as ranks  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    decode_state_specs, local_shape, shard_tensor, tree_shardings)
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.serve_step import ServeStep  # noqa: E402
from repro_torch.models.model import Model, tree_flatten  # noqa: E402

PREFILL_REL, DECODE_REL = tp_checks.STEP0_REL, tp_checks.LATER_REL
BF16_STEP = 2.0 ** -7
CASES = [c[0] for c in ranks.SERVE_CASES]
MESHES = ranks.TP_MESHES

one_thread = pytest.fixture(scope="module", autouse=True)(
    tp_checks.one_thread)


def _ref_model(base):
    _, arch, kw = next(c for c in ranks.TP_CASES if c[0] == base)
    cfg = dataclasses.replace(ref_configs.get_config(arch).reduced(), **kw)
    return RefModel(cfg, compute_dtype=jnp.float32,
                    q_chunk=ranks.SERVE_PROMPT, remat=False)


def _here(case, npp, ref_prefill):
    """The mesh-less step's results (``torch_ranks.serve_run``) and the
    reference's: its prefill cell, and its decode steps from the mesh-less
    prefill state, teacher-forced."""
    base, _ = ranks.serve_case(case)
    ref = _ref_model(base)
    got = ranks.serve_run(case, npp)
    prompts, teacher, enc = ranks.serve_inputs(ranks.tp_config(base))
    params = jax.tree.map(jnp.asarray, npp)
    if base not in ref_prefill:
        args = (jnp.asarray(prompts),) + (
            (jnp.asarray(enc),) if ref.cfg.family == "encdec" else ())
        ref_prefill[base] = np.asarray(jax.jit(ref.prefill)(params, *args))
    got["ref_prefill"] = ref_prefill[base]
    bf16 = {"k", "v", "cross_k", "cross_v"}
    state = {k: jnp.asarray(v, dtype=jnp.bfloat16 if k in bf16 and
                            v.dtype == np.float32 else v.dtype)
             for k, v in got["state"].items()}
    state["index"] = jnp.asarray(got["index"], jnp.int32)
    step = jax.jit(ref.decode_step)
    got["ref_decode"] = []
    for t in range(ranks.SERVE_NEW):
        logits, state = step(params, state, jnp.asarray(teacher[:, t:t + 1]))
        got["ref_decode"].append(np.asarray(logits))
    return got


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the ranks' results, this process's by case)."""
    tmp = tmp_path_factory.mktemp("serve")
    trees = {}
    for case in CASES:
        base, _ = ranks.serve_case(case)
        if base not in trees:
            _, trees[base] = tp_checks._ref_params(base)
            np.savez(tmp / f"{base}.npz",
                     **dict(tp_checks._flat_keys(trees[base])))
    here, ref_prefill = {}, {}

    def during():
        for case in CASES:
            here[case] = _here(case, trees[ranks.serve_case(case)[0]],
                               ref_prefill)

    res = ranks.run_ranks(ranks.serve_ranks, 4, str(tmp / "store"),
                          str(tmp), CASES, during=during)
    return res, here


def _close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _mine(res, rows):
    first, n = res["rows"]
    return rows[first:first + n]


@pytest.mark.parametrize("mesh", MESHES, ids=tp_checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_prefill_cell_matches_reference(world, case, mesh):
    """The reference's prefill cell: every rank's last logits (its rows,
    whole over vocab) against the reference's ``Model.prefill``."""
    want = world[1][case]["ref_prefill"]
    for res in world[0]:
        r = res[case, mesh]
        _close(r["prefill"], _mine(r, want), PREFILL_REL, "prefill")


@pytest.mark.parametrize("mesh", MESHES, ids=tp_checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_prefill_fills_each_rank_state_shard(world, case, mesh):
    """The decode step's prefill: its logits against the mesh-less step's,
    its ``index``, and each rank's shard of every state leaf against
    ``shard_tensor`` of the mesh-less state."""
    here = world[1][case]
    abstract = Mesh.abstract(mesh, ("data", "model"))
    shapes = {k: torch.empty(v.shape, device="meta")
              for k, v in here["state"].items()}
    specs = decode_state_specs(ranks.tp_config(ranks.serve_case(case)[0]),
                               shapes, abstract)
    for res in world[0]:
        r = res[case, mesh]
        _close(r["filled"], _mine(r, here["filled"]), PREFILL_REL, "filled")
        assert r["index"] == here["index"] == ranks.SERVE_PROMPT
        assert set(r["state"]) == set(here["state"])
        for key, whole in here["state"].items():
            want = shard_tensor(torch.from_numpy(whole), specs[key].spec,
                                abstract, r["coords"]).numpy()
            got = r["state"][key]
            assert got.shape == want.shape, key
            if key in ("k", "v") and whole.dtype == np.int8:
                assert int(np.abs(got.astype(np.int32)
                                  - want.astype(np.int32)).max()) <= 1, key
            elif key in ("k", "v", "cross_k", "cross_v"):
                assert np.all(np.abs(got - want)
                              <= BF16_STEP * np.abs(want) + 1e-30), key
            else:
                _close(got, want, PREFILL_REL, key)


@pytest.mark.parametrize("mesh", MESHES, ids=tp_checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_reference(world, case, mesh):
    """Teacher-forced decode steps: every rank's logits against the
    reference's ``decode_step`` from the same state."""
    want = world[1][case]["ref_decode"]
    for res in world[0]:
        r = res[case, mesh]
        for t, (g, w) in enumerate(zip(r["decode"], want)):
            _close(g, _mine(r, w), DECODE_REL, f"decode step {t}")


@pytest.mark.parametrize("mesh", MESHES, ids=tp_checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_only_its_shards(world, case, mesh):
    """The stored weights are ``local_shape`` of ``tree_shardings`` and the
    state's of ``decode_state_specs``; the rows are the rank's of
    ``data_spec``; the attention ran in the mode the heads give."""
    base, _ = ranks.serve_case(case)
    cfg = ranks.tp_config(base)
    abstract = Mesh.abstract(mesh, ("data", "model"))
    model = Model(cfg, torch.float32, device="cpu")
    p_shapes = model.param_shapes()
    plan = tree_shardings(p_shapes, model.param_logical_specs(), abstract)
    want = [local_shape(t.shape, s.spec, abstract) for t, s in
            zip(tree_flatten(p_shapes)[0], tree_flatten(plan)[0])]
    n_attn = model.mixer_counts()[0] * model.n_units
    # one call a self-attention layer in each of the prefill cell and the
    # decode step's prefill; the decoder's cross sub-blocks and the
    # encoder's layers as many again in each
    calls = 2 * n_attn * (1 + (cfg.family == "encdec")) + 2 * cfg.enc_layers
    mode = "heads" if cfg.n_heads % mesh[1] == 0 else "seq"
    for rank, res in enumerate(world[0]):
        r = res[case, mesh]
        assert r["param_shapes"] == want
        assert r["rows"] == (r["coords"]["data"] * ranks.SERVE_BATCH
                             // mesh[0], ranks.SERVE_BATCH // mesh[0])
        assert r["modes"] == {mode: calls, ("seq" if mode == "heads"
                                            else "heads"): 0}, rank


def test_seeded_weights_are_the_mesh_less_model_cast():
    """``load_params(seed=)`` draws leaf by leaf what ``Model.init_params``
    draws whole, in the compute dtype."""
    cfg = ranks.tp_config("dense")
    step = ServeStep(cfg, "prefill", 2, 8, device="cpu")
    got = tree_flatten(step.load_params(seed=3))[0]
    model = Model(cfg, torch.bfloat16, device="cpu")
    want = tree_flatten(model.cast(model.init_params(3)))[0]
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
               for a, b in zip(got, want))
