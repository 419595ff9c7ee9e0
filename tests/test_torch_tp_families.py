"""Tensor parallelism and FSDP storage for the ssm and hybrid families:
one spawn of four gloo ranks (``tests/torch_ranks.py``) trains each
reduced config in f32 on a (2, 2) and a (1, 4) mesh (mamba2, jamba, and
a jamba of 3 experts and 2 SSD heads in one group, whose experts split
neither axis and whose heads split only two ways), held against
``Trainer(mesh=None)`` and the reference's ``jax.value_and_grad`` as
``tests/tp_checks.py`` states.  The dense, moe and encdec families and
the mesh-wide checks are ``tests/test_torch_tp.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")

import tp_checks as checks  # noqa: E402

CASES = ("ssm", "hybrid", "hybrid_odd")

one_thread = pytest.fixture(scope="module", autouse=True)(checks.one_thread)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return checks.world(tmp_path_factory, CASES, extras=False)


@pytest.mark.parametrize("mesh", checks.MESHES, ids=checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_step0_loss_and_gradients(world, case, mesh):
    checks.step0(world, case, mesh)


@pytest.mark.parametrize("mesh", checks.MESHES, ids=checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_steps_match_one_device(world, case, mesh):
    checks.steps(world, case, mesh)


@pytest.mark.parametrize("mesh", checks.MESHES, ids=checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_each_rank_stores_its_shards(world, case, mesh):
    checks.shards(world, case, mesh)
