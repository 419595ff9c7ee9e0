"""The port's dry run of the training and serving cells
(``repro_torch.launch.dryrun`` over ``launch/cost_analysis.py``), on the
CPU: no card, and full-width configurations traced on ``meta`` tensors,
which allocate nothing.

* The full-width smollm-360m shards per rank at ``train_4k`` on fake
  (2, 2) and (1, 4) worlds: the bytes measured on the card (PERF.md §6).
* FLOPs: the port's traced step against ``repro.launch.hlo_analysis``'s
  count of the reference's step (``build_cell`` on a 1 x 1 mesh, lowered
  and compiled on the CPU) for smollm ``.reduced()`` at S 64, batch 8,
  in two loss chunks, with remat and without, within ``FLOP_REL``; the
  ratios are printed.
* The serving steps' FLOPs (``ServeStep``'s prefill, and one decode
  against a full cache) against ``hlo_analysis``'s count of the
  reference's jitted prefill and decode cells (``build_cell`` on a 1 x 1
  mesh, with its shardings) for smollm ``.reduced()`` at S 64, batch 8,
  the decode with and without the int8 cache, within ``FLOP_REL``.
* smollm-360m's production cells on both meshes, training, prefill_32k
  and decode_32k (also with ``--kv-quant``), mamba2-370m's long_500k (the
  other tier-1 cells are ``tests/test_torch_dryrun_cells.py``'s), the
  cells the reference skips, the records' files and ``main``.
The live ranks' collective and stored bytes are held to the dry run's in
``tests/test_torch_tp.py``, which spawns them.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import dryrun_checks as checks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

# the port counts each product once as it runs; XLA's HLO may drop or
# add some (recomputation, fusion): within 5%
FLOP_REL = 0.05
# f32 parameter shards of full-width smollm-360m a rank stores (PERF.md
# §6, measured on the card)
SMOLLM_SHARD_BYTES = {(2, 2): 409_069_440, (1, 4): 409_194_240}
SMALL = ShapeConfig(name="train_s64", seq_len=64, global_batch=8,
                    kind="train")
# two loss chunks on both sides: at one, XLA unrolls the one-trip scan
# over the chunks and merges the head product's remat recompute with the
# forward's (PERF.md §6)
SMALL_LOSS_CHUNK = 32


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dryrun module: it sets XLA_FLAGS when imported, so
    the JAX backend is started first and the flag put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


@pytest.mark.parametrize("mesh", sorted(SMOLLM_SHARD_BYTES))
def test_full_width_shards_match_the_card(mesh):
    cfg = configs.get_config("smollm_360m")
    with cost_analysis.fake_world(4):
        trainer, _ = dryrun.build_cell(
            cfg, configs.SHAPES["train_4k"],
            make_debug_mesh(*mesh, device="meta"))
        params = cost_analysis._meta_params(trainer)
    got = sum(t.numel() * t.element_size()
              for t in cost_analysis._tensors(params))
    assert got == SMOLLM_SHARD_BYTES[mesh]


def _ref_flops(ref_dryrun, remat: bool) -> float:
    """``hlo_analysis.analyze`` of the reference's step for the reduced
    smollm at ``SMALL`` on one device."""
    from jax.sharding import Mesh as JMesh

    from repro import configs as ref_configs
    from repro.launch.hlo_analysis import analyze
    from repro.models.act_sharding import clear_policy
    from repro.models.model import Model as RefModel

    cfg = ref_configs.get_config("smollm_360m").reduced()
    shape = ref_configs.ShapeConfig(name=SMALL.name, seq_len=SMALL.seq_len,
                                    global_batch=SMALL.global_batch,
                                    kind="train")
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    base = ref_dryrun._model_for

    def model_for(c, s):
        m = base(c, s)
        return RefModel(c, q_chunk=m.q_chunk, ssd_chunk=m.ssd_chunk,
                        loss_chunk=SMALL_LOSS_CHUNK, remat=remat)
    ref_dryrun._model_for = model_for
    try:
        with mesh:
            fn, args, _ = ref_dryrun.build_cell(cfg, shape, mesh)
            hlo = fn.lower(*args).compile().as_text()
    finally:
        ref_dryrun._model_for = base
        clear_policy()
    return analyze(hlo).flops


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_step_flops_match_the_reference_hlo(ref_dryrun, remat):
    cfg = configs.get_config("smollm_360m").reduced()
    model = dryrun._model_for(cfg, SMALL)
    trainer = Trainer(cfg, batch=SMALL.global_batch, seq_len=SMALL.seq_len,
                      device="meta", compute_dtype=model.compute_dtype,
                      remat=remat, q_chunk=model.q_chunk,
                      loss_chunk=SMALL_LOSS_CHUNK)
    got = cost_analysis.trace_step(trainer).cost.flops
    want = _ref_flops(ref_dryrun, remat)
    print(f"port/reference step FLOPs ({'remat' if remat else 'no remat'}):"
          f" {got:.0f} / {want:.0f} = {got / want:.4f}")
    assert got == pytest.approx(want, rel=FLOP_REL)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_smollm_training_cell(mesh_kind):
    checks.training_cell("smollm_360m", mesh_kind)


def _ref_serving_flops(ref_dryrun, shape, kv_quant: bool) -> float:
    """``hlo_analysis.analyze`` of the reference's serving cell for the
    reduced smollm at ``shape`` on a 1 x 1 mesh."""
    from jax.sharding import Mesh as JMesh

    from repro import configs as ref_configs
    from repro.launch.hlo_analysis import analyze
    from repro.models.act_sharding import clear_policy

    cfg = ref_configs.get_config("smollm_360m").reduced()
    ref_shape = ref_configs.ShapeConfig(
        name=shape.name, seq_len=shape.seq_len,
        global_batch=shape.global_batch, kind=shape.kind)
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    try:
        with mesh:
            fn, args, _ = ref_dryrun.build_cell(cfg, ref_shape, mesh,
                                                kv_quant=kv_quant)
            hlo = fn.lower(*args).compile().as_text()
    finally:
        clear_policy()
    return analyze(hlo).flops


@pytest.mark.parametrize("kind,kv_quant", [("prefill", False),
                                           ("decode", False),
                                           ("decode", True)],
                         ids=["prefill", "decode", "decode_kvq8"])
def test_serving_flops_match_the_reference_hlo(ref_dryrun, kind, kv_quant):
    cfg = configs.get_config("smollm_360m").reduced()
    shape = ShapeConfig(name=f"{kind}_s64", seq_len=SMALL.seq_len,
                        global_batch=SMALL.global_batch, kind=kind)
    step, _ = dryrun.build_cell(cfg, shape, None, kv_quant=kv_quant)
    got = cost_analysis.trace_step(step).cost.flops
    want = _ref_serving_flops(ref_dryrun, shape, kv_quant)
    print(f"port/reference {kind} FLOPs{' (int8 cache)' * kv_quant}: "
          f"{got:.0f} / {want:.0f} = {got / want:.4f}")
    assert got == pytest.approx(want, rel=FLOP_REL)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_smollm_serving_cell(shape, mesh_kind):
    rec = checks.serving_cell("smollm_360m", shape, mesh_kind)
    parts = rec["memory"]["argument_parts"]
    # bf16 weights over the mesh's ranks (vocab and heads over "model",
    # embed over the data axes; norms replicated, so a little more)
    n = rec["n_chips"]
    P = configs.get_config("smollm_360m").param_count()
    assert 2 * P / n <= parts["params"] < 1.05 * 2 * P / n
    if shape == "decode_32k":
        assert parts["state"] > 0 and rec["collectives"]["per_op"][
            "all_reduce"] > 0


@pytest.mark.parametrize("arch", ["smollm_360m", "phi3_mini_3_8b"])
def test_kv_quant_decode_cell(arch):
    """The int8 cache's state against the bf16 cache's, per rank: 1 byte a
    value for 2, and an f32 scale per (position, kv head).  The scales
    split over "model" only with the kv heads (phi3-mini's 32 on 16:
    (96 + 4) / (2 * 96)); smollm's 5 kv heads split head_dim instead,
    64 / 16 = 4 values a rank beside a whole scale: (4 + 4) / (2 * 4),
    no saving."""
    cfg = configs.get_config(arch)
    bf16 = checks.serving_cell(arch, "decode_32k", "single")
    int8 = checks.serving_cell(arch, "decode_32k", "single", kv_quant=True)
    assert int8["mesh"] == "single__kvq8" and int8["kv_quant"]
    ratio = int8["memory"]["argument_parts"]["state"] / \
        bf16["memory"]["argument_parts"]["state"]
    hd = cfg.head_dim if cfg.n_kv % 16 == 0 else cfg.head_dim // 16
    assert ratio == pytest.approx((hd + 4) / (2 * hd))


def test_long_context_cell_on_ssm():
    rec = checks.serving_cell("mamba2_370m", "long_500k", "single")
    assert rec["memory"]["argument_parts"]["state"] > 0


def test_long_context_on_full_attention_is_skipped():
    from repro import configs as ref_configs
    rec = dryrun.run_cell("smollm_360m", "long_500k", "multi", save=False)
    want = ref_configs.shape_applicable(
        ref_configs.get_config("smollm_360m"),
        ref_configs.SHAPES["long_500k"])
    assert (rec["status"], rec["reason"]) == ("skipped", want[1])


def test_main_writes_one_record_per_cell(tmp_path, monkeypatch):
    """``main`` over the flags: one file a cell in ``RESULTS_DIR``
    (``experiments/dryrun_torch`` by default, never the reference's
    ``experiments/dryrun``), ``--skip-existing`` leaves them be, and
    ``--kv-quant`` names its own files."""
    assert os.path.basename(os.path.normpath(dryrun.RESULTS_DIR)) == \
        "dryrun_torch"
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    recs = dryrun.main(["--arch", "smollm_360m", "--shape", "decode_32k",
                        "--mesh", "both"])
    assert [r["mesh"] for r in recs] == ["single", "multi"]
    names = sorted(os.listdir(tmp_path))
    assert names == ["smollm_360m__decode_32k__multi.json",
                     "smollm_360m__decode_32k__single.json"]
    with open(tmp_path / names[0]) as f:
        assert json.load(f)["status"] == "ok"
    assert dryrun.main(["--arch", "smollm_360m", "--shape", "decode_32k",
                        "--mesh", "both", "--skip-existing"]) == []
    recs = dryrun.main(["--arch", "smollm_360m", "--shape", "decode_32k",
                        "--kv-quant"])
    assert recs[0]["mesh"] == "single__kvq8" and recs[0]["kv_quant"]
    assert len(os.listdir(tmp_path)) == 3
