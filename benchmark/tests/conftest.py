"""Tests of the benchmark. Run from the repository's root:

    python -m pytest benchmark/tests -q            # the CPU cases
    python -m pytest benchmark/tests -m gpu -q     # on a card

Cases marked `gpu` need a CUDA card; the `card` fixture decides whether
one is there and skips the case otherwise."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """The program's caches in the test's own directory."""
    monkeypatch.setenv("CFDTPU_SYM_CACHE", str(tmp_path / "sym"))
    monkeypatch.setenv("CFDTPU_MESH_CACHE", str(tmp_path / "mesh"))
    return tmp_path
