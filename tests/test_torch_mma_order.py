"""The tolerance argument of the bf16 tensor-core video scores (B2 / B3-bf16,
csrc/video_score.cu) on the CPU.

The kernel multiplies bf16 by bf16 on the tensor cores (mma.sync m16n8k16)
and sums in f32: each k16 step forms an f32 partial sum of its 16 exact
products, folded into the accumulator in k order. ``tc_order_dots`` models
that order in torch. On unit-norm bf16 inputs, at D = 16 and 256 and on
adversarial rows (products of equal magnitude and alternating sign, and
rows whose partial sums cancel), the model's video scores are held to:

- the plain version ``video_scores_flat_plain`` within 1e-5 (the bound
  chip_smoke.py and the card tests hold the kernel to), with the top-k
  identical outside near-ties of 2e-5;
- the exact dot (f64) within (D - 1) 2^-24 sum |q_i f_i|, the worst case of
  any f32 summation order, which the plain version meets too;
- the JAX package's ``video_scores_pallas_flat`` in interpret mode at the
  smallest shape that crosses its video tile.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.ops import pallas_score as jp
from tvretrieval_tpu_torch.ops import video_score as vs
from tvretrieval_tpu_torch.ops.span import topk_stable
from tvretrieval_tpu_torch.testing import rank_mismatches

ATOL = 1e-5                 # chip_smoke.py::B2_ATOL, test_torch_kernels_cuda.py::F32_ATOL
K_STEP = 16                 # bf16 values of one m16n8k16 k-step


def tc_order_dots(q: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(Nq, D) x (R, D) bf16 -> (Nq, R) f32 dots in the tensor-core order:
    exact f32 products, an f32 sum of each k-step's 16 in order, the k-step
    sums added to the accumulator in k order."""
    prods = q.float()[:, None, :] * f.float()[None, :, :]       # exact: 8 + 8 bits
    acc = torch.zeros(prods.shape[:2], dtype=torch.float32)
    for k0 in range(0, prods.shape[-1], K_STEP):
        part = prods[..., k0]
        for i in range(k0 + 1, min(k0 + K_STEP, prods.shape[-1])):
            part = part + prods[..., i]
        acc = acc + part
    return acc


def tc_order_scores(qvt, qst, fv, fs, n_videos: int, lp: int) -> torch.Tensor:
    """The kernel's scores under that order: per stream the max over each
    video's lp rows, then (mv + ms) / 2 in f32; (Nq, n_videos)."""
    mv, ms = (tc_order_dots(q.T, f).view(q.shape[1], -1, lp).amax(dim=2)
              for q, f in ((qvt, fv), (qst, fs)))
    return ((mv + ms) / 2)[:, :n_videos]


def _unit_bf16(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True)).to(torch.bfloat16)


def _adversarial(rng, n, d):
    """Unit-norm bf16 rows against which the queries' products cancel:
    half are +-c in alternating sign (equal magnitudes), half carry a few
    large components of alternating sign over a small random remainder."""
    rows = np.empty((n, d), np.float32)
    sign = np.where(np.arange(d) % 2, -1.0, 1.0)
    rows[: n // 2] = sign / np.sqrt(d)
    rest = rng.normal(size=(n - n // 2, d)).astype(np.float32) * 0.01
    rest[:, :8] = sign[:8] * 0.35
    rows[n // 2:] = rest
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    return torch.from_numpy(rows).to(torch.bfloat16)


def _case(d, seed, nq=24, nv=40, lp=8, adversarial=False):
    rng = np.random.default_rng(seed)
    q = [_unit_bf16(rng, nq, d) for _ in range(2)]
    if adversarial:
        # queries of equal magnitudes too, so products are +-1/d in turn
        q[0][: nq // 2] = torch.full((nq // 2, d), 1.0 / np.sqrt(d)).to(torch.bfloat16)
        f = [_adversarial(rng, nv * lp, d) for _ in range(2)]
    else:
        f = [_unit_bf16(rng, nv * lp, d) for _ in range(2)]
    return q[0].T, q[1].T, f[0], f[1], nv, lp


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("d", [16, 256])
def test_tensor_core_order_within_the_bound(d, adversarial):
    qvt, qst, fv, fs, nv, lp = _case(d, seed=d + adversarial, adversarial=adversarial)
    model = tc_order_scores(qvt, qst, fv, fs, nv, lp)
    plain = vs.video_scores_flat_plain(qvt, qst, fv, fs, nv, lp)
    assert model.shape == plain.shape == (qvt.shape[1], nv)
    assert (model - plain).abs().max().item() <= ATOL
    pv, pi = topk_stable(plain, 10)
    _, mi = topk_stable(model, 10)
    assert rank_mismatches(pi.numpy(), pv.numpy(), mi.numpy(), atol=2 * ATOL) == 0


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("d", [16, 256])
def test_every_order_within_the_worst_case(d, adversarial):
    """Each dot of the model and of the plain version against the exact
    sum: within (D - 1) 2^-24 sum |q_i f_i|, itself at most ~(D - 1) 2^-24
    for unit vectors (1.5e-5 at D = 256)."""
    qvt, _, fv, _, _, _ = _case(d, seed=10 * d + adversarial, adversarial=adversarial)
    q, f = qvt.T, fv
    exact = q.double() @ f.double().T
    mass = q.double().abs() @ f.double().abs().T
    assert float(mass.max()) <= 1.0 + 2e-2                   # unit norms, up to bf16 rounding
    bound = (d - 1) * 2.0 ** -24 * mass
    for got in (tc_order_dots(q, f), q.float() @ f.float().T):
        assert bool(((got.double() - exact).abs() <= bound).all())


def test_tensor_core_order_against_the_pallas_kernel():
    """The smallest shape crossing the TPU kernel's video tile: 24 videos
    in tiles of 8, D = 16 (one k-step), lp = 8."""
    qvt, qst, fv, fs, nv, lp = _case(16, seed=3, nq=4, nv=24, lp=8)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    pal = np.asarray(jp.video_scores_pallas_flat(j(qvt), j(qst), j(fv), j(fs), nv, lp=lp,
                                                 chunk_v=8, interpret=True))
    model = tc_order_scores(qvt, qst, fv, fs, nv, lp).numpy()
    assert pal.shape == model.shape == (4, nv)
    np.testing.assert_allclose(model, pal, rtol=0, atol=ATOL)
