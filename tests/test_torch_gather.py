"""The byte-row gather (ops/gather.py, kernel B4): its plain version
against the JAX package's Pallas kernel in interpret mode, bit for bit, and
the wrapper's checks. The CUDA kernel itself runs only on a card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.ops.pallas_gather import gather_byte_rows as j_gather_byte_rows
from tvretrieval_tpu_torch.ops import _build, gather


@pytest.mark.parametrize("b", [1, 7, 8, 13])
def test_gather_plain_matches_pallas_interpret(b):
    rng = np.random.default_rng(b)
    src = rng.integers(-128, 128, size=(40, 8, 256), dtype=np.int8)
    idx = rng.integers(0, 40, size=b).astype(np.int32)
    if b > 1:
        idx[-1] = idx[0]                                    # a duplicate
    if b > 2:
        idx[1], idx[2] = 0, 39                              # the boundary rows
    want = np.asarray(j_gather_byte_rows(jnp.asarray(src), jnp.asarray(idx),
                                         interpret=True))
    np.testing.assert_array_equal(want, src[idx])
    _build.reset_launch_counts()
    for fn in (gather.gather_byte_rows_plain, gather.gather_byte_rows):
        got = fn(torch.from_numpy(src), torch.from_numpy(idx))
        assert got.dtype == torch.int8 and got.shape == (b, 8, 256)
        np.testing.assert_array_equal(got.numpy(), want)
    assert _build.LAUNCHES["gather_byte_rows"] == 0          # CPU: plain only


def test_gather_accepts_int64_and_strided_indices():
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(-128, 128, size=(9, 8, 128), dtype=np.int8))
    idx = torch.tensor([8, 0, 3, 3, 5, 1], dtype=torch.int64)
    want = src.numpy()[idx.numpy()]
    np.testing.assert_array_equal(gather.gather_byte_rows(src, idx).numpy(), want)
    strided = torch.stack([idx, idx], dim=1).to(torch.int32)[:, 0]
    assert not strided.is_contiguous()
    np.testing.assert_array_equal(gather.gather_byte_rows(src, strided).numpy(), want)


@pytest.mark.parametrize("table,idx,err", [
    (torch.zeros(4, 8, 128, dtype=torch.uint8), torch.zeros(2, dtype=torch.int32), TypeError),
    (torch.zeros(4, 4, 128, dtype=torch.int8), torch.zeros(2, dtype=torch.int32), TypeError),
    (torch.zeros(4, 8, 128, dtype=torch.int8), torch.zeros(2, dtype=torch.float32), TypeError),
    (torch.zeros(4, 8, 128, dtype=torch.int8), torch.zeros(2, 1, dtype=torch.int32), TypeError),
])
def test_gather_rejects_bad_operands(table, idx, err):
    for fn in (gather.gather_byte_rows, gather.gather_byte_rows_plain):
        with pytest.raises(err):
            fn(table, idx)


def test_check_indices_without_launches_is_quiet():
    gather.check_indices("cpu")
