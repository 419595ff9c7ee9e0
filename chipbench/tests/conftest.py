"""Fixtures of the benchmark's CPU tests: a tiny copy of the cells."""
import pytest

from .tiny import tiny_root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(root, manifest) of the tiny cells; model files cached per module."""
    return tiny_root(tmp_path_factory.mktemp("chipbench"))
