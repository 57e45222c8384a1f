"""Three of the four study kernels of the port (B7: ops.gather.gathered_similarity,
B9: ops.video_score.video_scores_masked, B10:
ops.fused_score.fused_video_scores_clip_major) against the JAX functions
they replace, on identical numpy inputs. The fourth, B8, is held in
tests/test_torch_study_topk.py (its JAX kernel takes half a minute a case
in interpret mode, so it has a file, and a test worker, of its own).

On the CPU a wrapper of the port runs its kernel's plain version; the JAX
Pallas kernels run as their own tests run them (``interpret=True``), and
beside them stands each one's XLA reference. What is held:

- B7: within rtol = atol = 1e-5 of the JAX kernel and of the XLA gather +
  einsum (f32 summation order), at the shapes of tests/test_pallas_gather.py;
- B9, B10: within 2e-4 of the JAX kernels (f32 summation order; 20 x that
  relative after the exp), fully masked videos exactly -1e10.

The CUDA kernels are held to the same plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.ops import pallas_kernels as jpk
from tvretrieval_tpu.ops.pallas_gather import gathered_similarity as j_gathered_similarity
from tvretrieval_tpu.ops.pallas_score import video_scores_pallas as j_video_scores_pallas
from tvretrieval_tpu.ops.pallas_score import video_scores_xla as j_video_scores_xla
from tvretrieval_tpu_torch.ops import _build, fused_score, gather
from tvretrieval_tpu_torch.ops import video_score as vs

T = torch.from_numpy


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------------ B7
def _gather_case(N, L, Nq, V1, D=128):
    rng = np.random.default_rng(N + Nq)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(N, L, D), f(N, L, D), f(Nq, D), f(Nq, D), \
        rng.integers(0, N, (Nq, V1)).astype(np.int32)


@pytest.mark.parametrize("N,L,Nq,V1", [(17, 16, 5, 7), (40, 24, 9, 12)])
def test_gathered_similarity_matches_jax_kernel_and_einsum(N, L, Nq, V1):
    vf2, sf2, vq, sq, idx = _gather_case(N, L, Nq, V1)
    _build.reset_launch_counts()
    got = gather.gathered_similarity(T(vq), T(sq), T(vf2), T(sf2), T(idx))
    assert got.shape == (Nq, V1, L) and got.dtype == torch.float32
    assert _build.LAUNCHES["gathered_similarity"] == 0          # CPU: the plain version
    jk = j_gathered_similarity(*map(jnp.asarray, (vq, sq, vf2, sf2, idx)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
    ref = (jnp.einsum("qd,qvld->qvl", vq, jnp.asarray(vf2)[idx])
           + jnp.einsum("qd,qvld->qvl", sq, jnp.asarray(sf2)[idx])) / 2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # int64 indices, and a query block smaller than the batch
    again = gather.gathered_similarity_plain(T(vq), T(sq), T(vf2), T(sf2), T(idx).long(),
                                             block_queries=2)
    assert torch.equal(again, got)


def test_gathered_similarity_bf16_casts_queries_and_accumulates_in_f32():
    vf2, sf2, vq, sq, idx = _gather_case(17, 16, 5, 7)
    b = lambda a: T(a).to(torch.bfloat16)
    got = gather.gathered_similarity(T(vq), T(sq), b(vf2), b(sf2), T(idx))
    assert got.dtype == torch.float32
    up = lambda a: b(a).float()
    ref = gather.gathered_similarity_plain(up(vq), up(sq), up(vf2), up(sf2), T(idx))
    assert torch.equal(got, ref)                   # bf16 products are exact in f32
    jk = j_gathered_similarity(vq, sq, jnp.asarray(vf2, jnp.bfloat16),
                               jnp.asarray(sf2, jnp.bfloat16), idx, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-4)


def test_gathered_similarity_guards():
    """The TPU kernel refuses L % 8 and D % 128 (DMA tiling); the port needs
    16-byte feature rows of at most MAX_CLIP_BYTES, and says so on any
    device."""
    x = torch.zeros(4, 10, 128)
    q = torch.zeros(2, 128)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    assert gather.gathered_similarity(q, q, x, x, idx).shape == (2, 3, 10)   # L = 10 is taken
    with pytest.raises(ValueError, match="multiple of 16"):
        gather.gathered_similarity(q[:, :6], q[:, :6], x[..., :6], x[..., :6], idx)
    with pytest.raises(ValueError, match=str(gather.MAX_CLIP_BYTES)):
        gather.gathered_similarity(torch.zeros(2, 1028), torch.zeros(2, 1028),
                                   torch.zeros(4, 2, 1028), torch.zeros(4, 2, 1028), idx)
    with pytest.raises(ValueError, match=r"\(Nq, V\)"):
        gather.gathered_similarity(q, q, x, x, idx[0])
    with pytest.raises(TypeError, match="int32 or int64"):
        gather.gathered_similarity(q, q, x, x, idx.float())
    with pytest.raises(ValueError, match="one CUDA device"):     # no plain run off the CPU
        gather.gathered_similarity(*(t.to("meta") for t in (q, q, x, x, idx)))


# ------------------------------------------------------------- B9, B10
def _score_case(nq, nv, L, d, seed):
    rng = np.random.default_rng(seed)
    qv, qs = _unit(rng.normal(size=(nq, d))), _unit(rng.normal(size=(nq, d)))
    fv, fs = _unit(rng.normal(size=(nv, L, d))), _unit(rng.normal(size=(nv, L, d)))
    lengths = rng.integers(1, L + 1, nv)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    mask[nv // 2] = 0.0                                          # a fully masked video
    return qv, qs, fv, fs, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nv,L,d,chunk_v", [(6, 16, 12, 32, 8), (5, 24, 20, 128, 4)])
def test_video_scores_masked_matches_jax_kernel(dtype, nq, nv, L, d, chunk_v):
    qv, qs, fv, fs, mask = _score_case(nq, nv, L, d, seed=nq + nv)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    _build.reset_launch_counts()
    got = vs.video_scores_masked(T(qv).to(tdt), T(qs).to(tdt), T(fv).to(tdt), T(fs).to(tdt),
                                 T(mask))
    assert got.shape == (nq, nv) and got.dtype == torch.float32
    assert _build.LAUNCHES["video_scores_masked"] == 0               # CPU: the plain version
    jargs = [jnp.asarray(a, jdt) for a in (qv, qs, fv, fs)] + [jnp.asarray(mask)]
    jk = j_video_scores_pallas(*jargs, chunk_v=chunk_v, interpret=True)
    jx = j_video_scores_xla(*jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=0, atol=2e-4)
    assert (got[:, nv // 2] == -1e10).all() and (np.asarray(jk)[:, nv // 2] == -1e10).all()


@pytest.mark.parametrize("alpha", [20.0, None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_video_scores_matches_jax_kernel(dtype, alpha):
    M, Nv, L, D, BV = 6, 16, 12, 32, 8
    q, _, f, _, mask = _score_case(M, Nv, L, D, seed=3)
    mask[3, 7:] = 0.0
    mask[-1] = 0.0                                               # a second fully masked video
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    _build.reset_launch_counts()
    got = fused_score.fused_video_scores(T(q).to(tdt), T(f).to(tdt), T(mask), alpha)
    assert _build.LAUNCHES["fused_video_scores_clip_major"] == 0
    jq, jf = jnp.asarray(q, jdt), jnp.asarray(f, jdt)
    jk = jpk.fused_video_scores(jq, jf, jnp.asarray(mask), alpha=alpha, block_videos=BV,
                                interpret=True)
    jx = jpk.fused_video_scores_xla(jq, jf, jnp.asarray(mask), alpha=alpha)
    for ref in (jk, jx):
        if alpha is None:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-4)
        else:       # exp(20 s): 2e-4 on s is 4e-3 relative
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=4e-3, atol=0)
    planted = 0.0 if alpha is not None else -1e10
    assert (got[:, -1] == planted).all() and (got[:, Nv // 2] == planted).all()
    # the clip-major entry point on the layout the JAX function takes
    direct = fused_score.fused_video_scores_clip_major(
        T(q).to(tdt), T(f).to(tdt).transpose(0, 1).contiguous(),
        T(mask).T[:, None, :].contiguous(), alpha)
    assert torch.equal(direct, got)
    plain = fused_score.fused_video_scores_xla(T(q).to(tdt), T(f).to(tdt), T(mask), alpha,
                                               block_videos=5)
    assert torch.allclose(plain, got, rtol=1e-6, atol=1e-7)


def test_fused_scores_take_any_video_count_and_one_stream_is_half_of_two():
    """Nv = 13 has no block size to divide (the TPU function asserts
    Nv % block_videos == 0); with both streams equal B9 is B10."""
    q, _, f, _, mask = (T(a) for a in _score_case(4, 13, 9, 16, seed=5))
    one = fused_score.fused_video_scores(q, f, mask)
    assert one.shape == (4, 13)
    assert torch.allclose(vs.video_scores_masked(q, q, f, f, mask), one, atol=1e-6)


def test_masked_score_wrappers_check_operands():
    q, _, f, _, mask = (T(a) for a in _score_case(4, 6, 5, 16, seed=6))
    with pytest.raises(ValueError, match=r"\(L, 1, Nv\)"):
        fused_score.fused_video_scores_clip_major(q, f.transpose(0, 1).contiguous(), mask.T)
    meta = lambda *ts: [t.to("meta") for t in ts]
    with pytest.raises(ValueError, match="one CUDA device"):     # no plain run off the CPU
        vs.video_scores_masked(*meta(q, q, f, f, mask))
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_score.fused_video_scores_clip_major(
            *meta(q, f.transpose(0, 1).contiguous(), mask.T[:, None, :].contiguous()))
    with pytest.raises(ValueError, match=r"\(Nv, L\)"):
        vs.video_scores_masked(*meta(q, q, f, f, mask[:, :3]))


# ------------------------------------------------------------- the build
@pytest.mark.parametrize("name,entry", [
    ("masked_score", "tvr_masked_scores"), ("gathered_sim", "tvr_gathered_similarity"),
    ("banded_topk", "tvr_banded_topk")])
def test_study_kernel_sources_are_registered(name, entry):
    source, entries = _build.SOURCES[name]
    assert source.exists() and source.suffix == ".cu" and entry in entries
    text = source.read_text()
    assert f"int {entry}(" in text and 'extern "C"' in text
    assert "cudaGetLastError()" in text and "#include <torch" not in text   # a plain C interface
    assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)
    assert _build.library_path(name).parent == _build.BUILD_DIR
