"""The check of one production training cell of the port's dry run
(``tests/test_torch_dryrun.py``, ``tests/test_torch_dryrun_cells.py``):
``run_cell`` gives an ``ok`` record with the reference's keys, a
positive step count, a dominant roofline term and a useful-FLOP ratio in
(0, 1.5]."""
import os

from repro_torch.launch import dryrun

# the cells a tier-1 run leaves out: each traces for 7-250 s on the CPU
OPT_IN = ["chameleon_34b", "phi3_mini_3_8b", "command_r_plus_104b",
          "starcoder2_3b", "grok_1_314b", "jamba_1_5_large_398b",
          "mamba2_370m"]
ALL = os.environ.get("REPRO_DRYRUN_ALL") == "1"
ALL_REASON = ("full-size cells that trace for minutes on the CPU: "
              "REPRO_DRYRUN_ALL=1 runs them (chip_smoke.py phase 17 runs "
              "every cell)")

KEYS = ("arch", "shape", "mesh", "timestamp", "status", "n_chips",
        "trace_s", "memory", "analytic_memory", "hlo_flops", "hlo_bytes",
        "collectives", "opt_state_dtype", "accum_steps", "roofline",
        "model_flops_global", "model_flops_per_chip", "useful_flop_ratio")


def training_cell(arch: str, mesh_kind: str) -> dict:
    rec = dryrun.run_cell(arch, "train_4k", mesh_kind, save=False)
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert set(KEYS) <= set(rec)
    assert rec["n_chips"] == (512 if mesh_kind == "multi" else 256)
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert 0 < rec["useful_flop_ratio"] <= 1.5
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(
        mem["argument_parts"].values())
    assert mem["temp_size_in_bytes"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    return rec


def cut_cell(arch: str, mesh_kind: str, n_layers: int) -> dict:
    """``arch`` at full width with its depth cut to ``n_layers``, built
    and traced as ``run_cell`` does (``build_cell``, ``trace_step``) on
    the production mesh: a family whose full depth traces for minutes on
    the CPU keeps its dry-run path in tier 1."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import cost_analysis
    from repro_torch.launch.mesh import make_production_mesh
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    multi = mesh_kind == "multi"
    with cost_analysis.fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        trainer, extra = dryrun.build_cell(cfg, SHAPES["train_4k"], mesh)
        got = cost_analysis.trace_step(trainer,
                                       dryrun.balanced_routing(cfg))
    assert got.cost.flops > 0 and got.cost.bytes_hbm > 0
    assert got.cost.collectives.total_bytes > 0
    assert got.memory["temp_size_in_bytes"] > 0
    return {"cost": got, **extra}
