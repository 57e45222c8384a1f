"""The port's native temporal NMS (csrc/temporal_nms.cpp through
native/loader.py) against its numpy path, and the numpy path kept where no
host compiler is found.

Rows are seeded: spans on a quarter-second grid and scores on a coarse grid,
so many scores tie (both paths keep ties in input order) and every value is
exact in float32, which the native path computes in.
"""
import numpy as np
import pytest

from tvretrieval_tpu.evaluation import nms as jnms
from tvretrieval_tpu_torch.evaluation import nms as tnms
from tvretrieval_tpu_torch.native import loader


def _rows(rng, n):
    st = rng.integers(0, 160, n) / 4
    return np.stack([st, st + rng.integers(1, 60, n) / 4,
                     rng.integers(0, 12, n) / 16], axis=1).tolist()


@pytest.fixture
def native():
    if not loader.native_available():
        pytest.skip("no host C++ compiler: the numpy path is the only one")
    return loader


@pytest.mark.parametrize("thd", [0.0, 0.3, 0.5, 0.7, 1.0])
def test_native_equals_numpy_on_rows_with_ties(native, thd):
    rng = np.random.default_rng(int(thd * 10))
    for n, max_after in ((2, 5), (25, 3), (60, 10), (200, 100)):
        preds = _rows(rng, n)
        got = tnms.temporal_nms(preds, thd, max_after)
        want = tnms.temporal_nms(preds, thd, max_after, use_native=False)
        assert got == want and 0 < len(got) <= max_after
        kept = native.temporal_nms_native(np.asarray(preds, np.float32), thd, max_after)
        assert kept.dtype == np.float32 and kept.tolist() == want
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        native.temporal_nms_native(np.zeros((4, 2), np.float32), thd, 3)


def test_post_processing_matches_the_jax_package(native):
    rng = np.random.default_rng(9)
    entries = [{"desc_id": i, "desc": "", "predictions": [
        [int(rng.integers(0, 3)), *row] for row in _rows(rng, 40)]} for i in range(5)]
    for task in ("SVMR", "VCMR"):
        kw = dict(nms_thd=0.5, max_before_nms=30, max_after_nms=10)
        assert tnms.POST_PROCESSING_NMS_FUNC[task](entries, **kw) == \
            jnms.POST_PROCESSING_NMS_FUNC[task](entries, **kw)


def test_the_library_is_built_into_the_port_and_numpy_stays_without_a_compiler(
        native, tmp_path, monkeypatch):
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == \
        "tvretrieval_tpu_torch"
    assert native.library_path().exists()
    preds = _rows(np.random.default_rng(2), 50)
    want = tnms.temporal_nms(preds, 0.4, 20, use_native=False)
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_load_failed", False)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert not loader.native_available() and not (tmp_path / "_build").exists()
    assert tnms.temporal_nms(preds, 0.4, 20) == want
    with pytest.raises(RuntimeError, match="unavailable"):
        loader.temporal_nms_native(np.asarray(preds, np.float32), 0.4, 20)
