"""Production training cells of the port's dry run on the (16, 16) mesh
(``launch.dryrun.run_cell``, checks in ``tests/dryrun_checks.py``): the
moe and encdec families at full size, and the hybrid at full width with
its depth cut to one attention period (8 of jamba's 72 layers; its full
depth traces for minutes on the CPU).  The (2, 16, 16) cells are
``tests/test_torch_dryrun_pods.py``'s; every other architecture's full
cells run with REPRO_DRYRUN_ALL=1 (and in ``chip_smoke.py`` phase 17).
"""
import pytest

pytest.importorskip("torch")

import dryrun_checks as checks  # noqa: E402


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "seamless_m4t_large_v2"])
def test_training_cell(arch):
    checks.training_cell(arch, "single")


def test_hybrid_cut_to_one_period():
    got = checks.cut_cell("jamba_1_5_large_398b", "single", 8)
    assert got["opt_state_dtype"] == "int8"


@pytest.mark.skipif(not checks.ALL, reason=checks.ALL_REASON)
@pytest.mark.parametrize("arch", checks.OPT_IN)
def test_every_other_training_cell(arch):
    checks.training_cell(arch, "single")
