"""The device-resident corpus (data/device_corpus.py) against the JAX
package's: quantized bytes, byte tables and assembled batches equal bit
for bit; under float32 storage the assembled batch equals the host
ExampleBuilder's."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tvretrieval_tpu.data import device_corpus as jdc
from tvretrieval_tpu.data.datasets import ExampleBuilder as JExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world as j_make_world
from tvretrieval_tpu_torch.data import device_corpus as tdc
from tvretrieval_tpu_torch.data.datasets import ExampleBuilder, tef_features
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world

NAMES = ("float32", "float16", "int8", "float8_e4m3fn")
WORLD = dict(n_videos=12, n_queries=40, vid_dim=32, text_dim=16, max_clips=12, seed=0)


def _worlds():
    out = []
    for make, cls in ((j_make_world, JExampleBuilder), (make_synthetic_world, ExampleBuilder)):
        w = make(**WORLD)
        out.append((w, cls(query_source=w.query_source, video_source=w.video_source,
                           sub_source=w.sub_source, ctx_mode="video_sub_tef",
                           max_desc_l=30, max_ctx_l=12, clip_length=w.clip_length)))
    return out


def _f8_probe():
    """l2-normalized rows (x 64 inside quantize), every e4m3 value and every
    midpoint between neighbours (exact ties), the subnormal range, zeros
    and values past the largest finite one."""
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(300, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    vals = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    vals = np.sort(vals[np.isfinite(vals)])
    mids = (vals[1:] + vals[:-1]) / 2
    sub = np.linspace(-2.0 ** -6, 2.0 ** -6, 1001, dtype=np.float32)   # below 2^-6: subnormal
    edge = np.array([0.0, -0.0, 448, 464, 465, 480, 1e4, -464, -465, -1e4], np.float32)
    return np.concatenate([rows.ravel(), (np.concatenate([vals, mids, sub, edge]) / 64)
                           .astype(np.float32)])


@pytest.mark.parametrize("name", NAMES)
def test_quantize_bytes_equal(name):
    x = _f8_probe() if name == "float8_e4m3fn" else \
        np.random.default_rng(1).normal(size=(50, 37)).astype(np.float32) * 0.4
    want = jdc.quantize(x, name)
    got = tdc.quantize(x, name)
    assert got.dtype == tdc.host_dtype(name) and got.itemsize == want.itemsize
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    back = tdc.dequantize(torch.from_numpy(got).view(tdc.storage_dtype(name)[0]), name)
    finite = np.isfinite(np.asarray(jdc.dequantize(jnp.asarray(want), name)))
    np.testing.assert_array_equal(back.numpy()[finite],
                                  np.asarray(jdc.dequantize(jnp.asarray(want), name))[finite])


@pytest.mark.parametrize("name", NAMES)
def test_byte_table_roundtrip_and_equal(name):
    raw = np.random.default_rng(0).normal(size=(6, 5, 37)).astype(np.float32) * 0.1
    jq, tq = jdc.quantize(raw, name), tdc.quantize(raw, name)
    jt, tt = jdc.to_byte_table(jq), tdc.to_byte_table(tq)
    assert tt.shape[1] == 8 and tt.shape[2] % 128 == 0 and tt.dtype == np.int8
    np.testing.assert_array_equal(tt, jt)
    back = tdc.from_byte_rows(torch.from_numpy(tt), 5, 37, name)
    assert back.dtype == tdc.storage_dtype(name)[0] and back.shape == (6, 5, 37)
    np.testing.assert_array_equal(back.view(torch.uint8).numpy().reshape(-1),
                                  np.ascontiguousarray(tq).view(np.uint8).reshape(-1))
    # a row without pad takes the no-copy branch
    exact = np.zeros((3, 8, 128), np.int8)
    assert tdc.from_byte_rows(torch.from_numpy(exact), 8, 32, "float32").shape == (3, 8, 32)


def test_storage_dtype_names():
    assert tdc.storage_dtype("float8_e4m3fn") == (torch.float8_e4m3fn, 64.0)
    assert tdc.storage_dtype("int8") == (torch.int8, 100.0)
    with pytest.raises(ValueError, match="unknown storage dtype"):
        tdc.storage_dtype("float64")


@pytest.mark.parametrize("name", ["float32", "float8_e4m3fn", "int8"])
def test_tables_and_assemble_batch_equal_jax(name):
    (jw, jb), (tw, tb) = _worlds()
    jctx = jdc.ContextTable.build(jb, jw.corpus, name)
    tctx = tdc.ContextTable.build(tb, tw.corpus, name, chunk=5)
    jqt = jdc.QueryTable.build(jb, jw.annotations, jw.corpus, jctx.ctx_l, name)
    tqt = tdc.QueryTable.build(tb, tw.annotations, tw.corpus, tctx.ctx_l, name, chunk=16)
    for a, b in ((jctx.v_feats, tctx.v_feats), (jctx.s_feats, tctx.s_feats),
                 (jqt.q_feats, tqt.q_feats)):
        np.testing.assert_array_equal(np.ascontiguousarray(b).view(np.uint8),
                                      np.ascontiguousarray(a).view(np.uint8))
    for k in ("q_len", "slot", "st_ed"):
        np.testing.assert_array_equal(getattr(tqt, k), getattr(jqt, k))
    np.testing.assert_array_equal(tctx.ctx_l, jctx.ctx_l)
    assert tctx.shapes == jctx.shapes and tctx.nbytes() == jctx.nbytes()

    idx = np.array([3, 17, 17, 0, 39, 8, 21])                  # a duplicate slot among them
    kw = dict(dtype_name=name, use_video=True, use_sub=True, use_tef=True, max_desc_l=30)
    want = jdc.assemble_batch(jctx.device_arrays(), *map(jnp.asarray, jqt.chunk(idx)),
                              **kw, **jctx.shapes)
    got = tdc.assemble_batch(tctx.device_arrays("cpu"), *map(torch.from_numpy, tqt.chunk(idx)),
                             **kw, **tctx.shapes)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if name == "float32":
        ref = tb.build_train_batch([tw.annotations[i] for i in idx]).model_inputs()
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_tef_recompute_equals_host_tef_for_every_length():
    n = torch.arange(0, 101, dtype=torch.int32)
    v = torch.zeros(101, 100, 4)
    out, mask, _, _ = tdc._finish_context(v, v, n, use_video=True, use_sub=True, use_tef=True)
    for k in range(1, 101):
        np.testing.assert_array_equal(out[k, :k, -2:].numpy(), tef_features(k))
        assert out[k, k:].abs().sum() == 0 and mask[k].sum() == k
    assert out[0].abs().sum() == 0 and mask[0].sum() == 0


def test_assemble_context_slice_equals_gathered_rows():
    _, (tw, tb) = _worlds()
    ctx = tdc.ContextTable.build(tb, tw.corpus, "float8_e4m3fn")
    dev = ctx.device_arrays("cpu")
    kw = dict(dtype_name="float8_e4m3fn", use_video=True, use_sub=True, use_tef=True,
              **ctx.shapes)
    a = tdc.assemble_context_slice(dev, 4, 5, **kw)
    b = tdc.assemble_context(dev, torch.arange(4, 9, dtype=torch.int32), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    vb, _ = tb.build_contexts(tw.corpus.vid_names[4:9], tw.corpus.durations[4:9])[:2]
    # e4m3 with x 64 scaling: <= 2^-4 relative error on l2-normalized values
    np.testing.assert_allclose(a[0][..., :-2].numpy(), vb[..., :-2], rtol=0.07, atol=1e-4)
    np.testing.assert_array_equal(a[0][..., -2:].numpy(), vb[..., -2:])       # exact TEF


def test_gather_rows_kernel_flag_follows_the_device():
    """No flag chooses between the gather kernel and its plain version: the
    table's device does. A CPU table takes the plain version (no launch is
    counted) and the assembly functions take no ``use_kernel``."""
    from tvretrieval_tpu_torch.ops import _build
    table = torch.arange(4 * 8 * 128, dtype=torch.int32).to(torch.int8).view(4, 8, 128)
    idx = torch.tensor([1, 3], dtype=torch.int32)
    _build.reset_launch_counts()
    assert torch.equal(tdc.gather_byte_rows(table, idx), table[idx.long()])
    assert _build.LAUNCHES["gather_byte_rows"] == 0
    with pytest.raises(ValueError, match="cpu or cuda"):
        tdc.gather_byte_rows(table.to("meta"), idx.to("meta"))
    with pytest.raises(TypeError, match="use_kernel"):
        tdc.assemble_context({}, idx, dtype_name="float16", use_video=True, use_sub=True,
                             use_tef=True, v_shape=(1, 1), s_shape=(1, 1), use_kernel=False)


def test_build_device_data_cpu():
    _, (tw, tb) = _worlds()
    dd = tdc.build_device_data(tb, tw.corpus, tw.annotations[:30], tw.annotations[30:],
                               dtype_name="float16", device="cpu")
    assert not hasattr(dd, "use_kernel") and dd.device.type == "cpu"
    assert dd.retrieval_queries is dd.eval_queries and len(dd.train_queries.q_len) == 30
    assert dd.ctx_device["v_bytes"].dtype == torch.int8
    assert dd.assemble_kwargs["v_shape"] == (12, 34)
