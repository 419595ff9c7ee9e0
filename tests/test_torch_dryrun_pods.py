"""Production training cells of the port's dry run on the two-pod
(2, 16, 16) mesh (``launch.dryrun.run_cell``, checks in
``tests/dryrun_checks.py``): the moe and encdec families at full size,
and the ssm family at full width with its depth cut to 8 of mamba2's 64
layers (its full depth traces for minutes on the CPU).  Every other
architecture's full cells run with REPRO_DRYRUN_ALL=1 (and in
``chip_smoke.py`` phase 17).
"""
import pytest

pytest.importorskip("torch")

import dryrun_checks as checks  # noqa: E402


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "seamless_m4t_large_v2"])
def test_training_cell(arch):
    checks.training_cell(arch, "multi")


def test_ssm_cut_to_eight_layers():
    checks.cut_cell("mamba2_370m", "multi", 8)


@pytest.mark.skipif(not checks.ALL, reason=checks.ALL_REASON)
@pytest.mark.parametrize("arch", checks.OPT_IN)
def test_every_other_training_cell(arch):
    checks.training_cell(arch, "multi")
