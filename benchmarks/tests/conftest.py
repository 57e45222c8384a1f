"""Fixtures of the benchmark's tests: a tiny checkout-like root, and the
card where a test asks for one (decided inside the fixture, never at
import, so that every worker collects the same tests)."""
from __future__ import annotations

import sys

import pytest
import torch

from benchmarks.tests import tiny

if str(tiny.ROOT) not in sys.path:
    sys.path.insert(0, str(tiny.ROOT))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param
