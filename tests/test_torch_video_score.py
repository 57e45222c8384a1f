"""Cache builders, int8 quantizers and the plain versions of the CUDA
video-score kernels (tvretrieval_tpu_torch.ops.video_score) against the
JAX package (tvretrieval_tpu.ops.pallas_score), on the CPU: byte-identical
caches and quantized bytes, the B1 plain version bit-equal to the XLA int8
reference and to the Pallas kernel in interpret mode, B2 / B3 as the JAX
package's own tests run them (tests/test_pallas_score.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.ops import pallas_score as jp
from tvretrieval_tpu_torch.ops import video_score as vs

T = torch.from_numpy


def _case(nq, nv, l, d, seed, mask_kind="prefix"):
    rng = np.random.default_rng(seed)
    norm = lambda x: x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
    qv = norm(rng.normal(size=(nq, d)).astype(np.float32))
    qs = norm(rng.normal(size=(nq, d)).astype(np.float32))
    fv = norm(rng.normal(size=(nv, l, d)).astype(np.float32))
    fs = norm(rng.normal(size=(nv, l, d)).astype(np.float32))
    if mask_kind == "prefix":
        lengths = rng.integers(1, l + 1, size=nv)
        mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    else:  # any mask with >= 1 valid clip, clip 0 masked everywhere
        mask = (rng.random((nv, l)) < 0.5).astype(np.float32)
        mask[:, l // 2] = 1.0
        mask[:, 0] = 0.0
    return qv, qs, fv, fs, mask


def _flat_pair(f, mask, lp, chunk_v):
    j = np.asarray(jp.build_flat_feat1(jnp.asarray(f), jnp.asarray(mask), lp=lp,
                                       chunk_v=chunk_v))
    t = vs.build_flat_feat1(T(f), T(mask), lp=lp, chunk_v=chunk_v).numpy()
    return j, t


@pytest.mark.parametrize("nv,l,d,lp,chunk_v,mask_kind", [
    (37, 12, 16, 16, 8, "prefix"),     # Nv padded up to a chunk_v multiple
    (16, 7, 8, 8, 4, "prefix"),        # lp == 8
    (24, 12, 16, 16, 8, "scattered"),  # first valid clip is not clip 0
])
def test_build_flat_feat1_identical(nv, l, d, lp, chunk_v, mask_kind):
    _, _, fv, _, mask = _case(3, nv, l, d, seed=nv, mask_kind=mask_kind)
    j, t = _flat_pair(fv, mask, lp, chunk_v)
    assert t.shape == j.shape == (-(-nv // chunk_v) * chunk_v * lp, d)
    np.testing.assert_array_equal(t, j)
    assert vs.flat_lp(l) == jp.flat_lp(l)


def test_build_flat_feat1_rejects_empty_video_and_bad_lp():
    _, _, fv, _, mask = _case(3, 16, 8, 8, seed=5)
    mask[4] = 0.0
    with pytest.raises(ValueError, match="no valid clip"):
        vs.build_flat_feat1(T(fv), T(mask), lp=8, chunk_v=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        vs.build_flat_feat1(T(fv), T(np.ones_like(mask)), lp=12)


def _half_ties_unit():
    """f32 x whose f32 product x * 127 is exactly k + 0.5: the rounding
    must go to even, as jnp.round does."""
    out = []
    for k in range(-127, 127):
        x = np.float32((k + 0.5) / 127.0)
        if np.float32(x * np.float32(127.0)) == np.float32(k + 0.5):
            out.append(x)
    assert len(out) > 20
    return np.asarray(out, np.float32)


def test_quantize_unit_i8_identical():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(50, 33)).astype(np.float32)
    x = np.concatenate([x.ravel(), _half_ties_unit(), [1.0, -1.0, 0.0]]).astype(np.float32)
    j = np.asarray(jp.quantize_unit_i8(jnp.asarray(x)))
    t = vs.quantize_unit_i8(T(x))
    assert t.dtype == torch.int8
    np.testing.assert_array_equal(t.numpy(), j)


def test_quantize_rows_i8_identical():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 5, 24)).astype(np.float32) * 3
    x[2, 1] = 0.0                                   # all-zero row
    # a row with max |x| = 127 has scale exactly 1: x / s = x, so the
    # planted k + 0.5 entries are exact ties
    x[4, 0] = np.arange(24, dtype=np.float32) - 11.5
    x[4, 0, 0] = 127.0
    for axis in (-1, 1):
        jq, js = jp.quantize_rows_i8(jnp.asarray(x), axis=axis)
        tq, ts = vs.quantize_rows_i8(T(x), axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("nq,nv,l,d,lp,chunk_v,mask_kind", [
    (6, 37, 12, 16, 16, 8, "prefix"),
    (3, 16, 7, 8, 8, 4, "prefix"),
    (5, 24, 12, 16, 16, 8, "scattered"),
])
def test_b1_plain_bit_equal_to_int8_reference_and_pallas(nq, nv, l, d, lp, chunk_v,
                                                         mask_kind):
    qv, qs, fv, fs, mask = _case(nq, nv, l, d, seed=nq + nv, mask_kind=mask_kind)
    fvf = jp.quantize_unit_i8(jp.build_flat_feat1(jnp.asarray(fv), jnp.asarray(mask),
                                                  lp=lp, chunk_v=chunk_v))
    fsf = jp.quantize_unit_i8(jp.build_flat_feat1(jnp.asarray(fs), jnp.asarray(mask),
                                                  lp=lp, chunk_v=chunk_v))
    qv8, qs8 = jp.quantize_unit_i8(jnp.asarray(qv)), jp.quantize_unit_i8(jnp.asarray(qs))
    ref = np.asarray(jp.video_scores_int8_xla(qv8, qs8, fvf, fsf, nv, lp=lp))
    pal = np.asarray(jp.video_scores_pallas_flat_i8(qv8.T, qs8.T, fvf, fsf, nv, lp=lp,
                                                    chunk_v=chunk_v, interpret=True))
    a = [T(np.array(x)) for x in (qv8, qs8, fvf, fsf)]
    out = vs.video_scores_flat_i8(a[0].T, a[1].T, a[2], a[3], nv, lp=lp)
    assert out.dtype == torch.float32 and out.shape == (nq, nv)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), pal)
    np.testing.assert_array_equal(
        vs.video_scores_int8_xla(a[0], a[1], a[2], a[3], nv, lp).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nv,l,d,lp,chunk_v", [
    (6, 37, 12, 16, 16, 8),
    (4, 64, 20, 32, 24, 16),
])
def test_b2_plain_matches_pallas_and_einsum(dtype, nq, nv, l, d, lp, chunk_v):
    """The JAX package pins its flat kernel bit-equal to the einsum path;
    the port's plain version and einsum path agree with them to f32
    summation order (a 256-term-at-most dot of unit vectors: 1e-6)."""
    qv, qs, fv, fs, mask = _case(nq, nv, l, d, seed=nq * 7 + nv)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcast = lambda x: jnp.asarray(x).astype(jdt)
    tcast = lambda x: T(x).to(tdt)
    ref = np.asarray(jp.video_scores_xla(jcast(qv), jcast(qs), jcast(fv), jcast(fs),
                                         jnp.asarray(mask)))
    fvf = jp.build_flat_feat1(jcast(fv), jnp.asarray(mask), lp=lp, chunk_v=chunk_v)
    fsf = jp.build_flat_feat1(jcast(fs), jnp.asarray(mask), lp=lp, chunk_v=chunk_v)
    pal = np.asarray(jp.video_scores_pallas_flat(jcast(qv).T, jcast(qs).T, fvf, fsf, nv,
                                                 lp=lp, chunk_v=chunk_v, interpret=True))
    tfv = vs.build_flat_feat1(tcast(fv), T(mask), lp=lp, chunk_v=chunk_v)
    tfs = vs.build_flat_feat1(tcast(fs), T(mask), lp=lp, chunk_v=chunk_v)
    np.testing.assert_array_equal(tfv.float().numpy(), np.asarray(fvf.astype(jnp.float32)))
    out = vs.video_scores_flat(tcast(qv).T, tcast(qs).T, tfv, tfs, nv, lp=lp)
    assert out.shape == (nq, nv) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), pal, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    ein = vs.video_scores_xla(tcast(qv), tcast(qs), tcast(fv), tcast(fs), T(mask))
    np.testing.assert_allclose(ein.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nv,chunk_v", [(21, 8), (24, 12), (40, 16)])
def test_b3_plain_matches_pallas_bmax(int8, nv, chunk_v):
    """Scores match the plain flat kernel, pad videos are -inf, and bmax
    is the exact maximum of each chunk = gcd(Nv_pad, chunk_v) block (the
    TPU wrapper treats chunk_v as an upper bound)."""
    nq, l, d, lp = 5, 12, 16, 16
    qv, qs, fv, fs, mask = _case(nq, nv, l, d, seed=3)
    build_chunk = 8
    fvf = jp.build_flat_feat1(jnp.asarray(fv), jnp.asarray(mask), lp=lp,
                              chunk_v=build_chunk)
    fsf = jp.build_flat_feat1(jnp.asarray(fs), jnp.asarray(mask), lp=lp,
                              chunk_v=build_chunk)
    qvt, qst = jnp.asarray(qv).T, jnp.asarray(qs).T
    if int8:
        fvf, fsf = jp.quantize_unit_i8(fvf), jp.quantize_unit_i8(fsf)
        qvt, qst = jp.quantize_unit_i8(jnp.asarray(qv)).T, jp.quantize_unit_i8(jnp.asarray(qs)).T
    js, jb = (np.asarray(x) for x in jp.video_scores_pallas_flat_bmax(
        qvt, qst, fvf, fsf, n_videos=nv, lp=lp, chunk_v=chunk_v, interpret=True))
    a = [T(np.array(x)) for x in (qvt, qst, fvf, fsf)]
    ts, tb = vs.video_scores_flat_bmax(*a, n_videos=nv, lp=lp, chunk_v=chunk_v)
    nv_pad = a[2].shape[0] // lp
    chunk = np.gcd(nv_pad, chunk_v)
    assert ts.shape == js.shape == (nq, nv_pad)
    assert tb.shape == jb.shape == (nq, nv_pad // chunk)
    assert torch.all(ts[:, nv:] == -np.inf)
    np.testing.assert_array_equal(tb.numpy(), ts.view(nq, -1, chunk).amax(2).numpy())
    if int8:
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(tb.numpy(), jb)
    else:
        np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-6)


def test_wrappers_on_cpu_run_plain_and_count_nothing():
    qv, qs, fv, fs, mask = _case(4, 20, 10, 16, seed=2)
    fvf = vs.quantize_unit_i8(vs.build_flat_feat1(T(fv), T(mask), chunk_v=8))
    fsf = vs.quantize_unit_i8(vs.build_flat_feat1(T(fs), T(mask), chunk_v=8))
    q8 = [vs.quantize_unit_i8(T(q)).T for q in (qv, qs)]
    vs.reset_launch_counts()
    vs.video_scores_flat_i8(q8[0], q8[1], fvf, fsf, 20, lp=16)
    vs.video_scores_flat_bmax(q8[0], q8[1], fvf, fsf, 20, lp=16)
    vs.video_scores_flat(q8[0].float(), q8[1].float(), fvf.float(), fsf.float(), 20, lp=16)
    assert all(v == 0 for v in vs.LAUNCHES.values())
    # the launch path refuses tensors that are not on a CUDA device
    with pytest.raises(ValueError, match="CUDA device"):
        vs._launch("video_scores_flat_i8", q8[0], q8[1], fvf, fsf, 20, 16)
    assert all(v == 0 for v in vs.LAUNCHES.values())
