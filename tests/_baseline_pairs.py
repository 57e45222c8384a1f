"""Helpers shared by the baseline tests (tests/test_torch_{baselines,cal,
excl,baseline_cli}.py); ``one_torch_thread`` also by
tests/test_torch_{profiling,backbones,features}.py.

``JaxTrainer``: the JAX package's GenericTrainer on one device, started
from given variables; the port's trainer is held against it. Skipping its
own ``model.init`` (run op by op, which compiles each scan separately)
keeps the scan-LSTM compiles to the step's one.

``one_torch_thread``: the port's side of these tests is small ops, each a
parallel region over torch's intra-op threads; beside the other test
workers those threads wait on each other's time slices (a CLI test took
2x longer with 8 threads than with 1 on a loaded machine). The module's
tests run on one thread, the former count restored after."""
import pytest
import torch

from tvretrieval_tpu.parallel.mesh import make_mesh
from tvretrieval_tpu.training.generic import GenericTrainer


class JaxTrainer(GenericTrainer):
    def __init__(self, variables, *args, **kwargs):
        self._given = variables
        super().__init__(*args, mesh=make_mesh(1), **kwargs)

    def _init_variables(self, rngs, batch):
        return self._given


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
