"""The tolerance arguments of the tensor-core video scores on the CPU: B2 /
B3 in bf16 and in f32 (csrc/video_score.cu) and the masked scores B9 / B10
(csrc/masked_score.cu), all on wgmma, the f32 kinds through the 3xTF32
split of csrc/s8_mma.cuh.

The kernels multiply bf16 by bf16 on the tensor cores (wgmma m64nNk16) and
sum in f32: each k16 step forms an f32
partial sum of its 16 exact products, folded into the accumulator in k
order. ``tc_order_dots`` models
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

The f32 kind splits each operand x into hi = rna_tf32(x) and lo =
rna_tf32(x - hi) (``rna_tf32``: 11 significant bits, ties away from zero,
cvt.rna.tf32.f32) and forms hi.hi + hi.lo + lo.hi with three TF32 m16n8k8
products a k-step of 8, the small ones first, in one f32 accumulator.
``tf32x3_dots`` models that; on unit-norm rows drawn in f32 (full 24-bit
mantissas: values upcast from bf16 are exact in TF32 and would hide a lost
split) its scores are held to the plain version within the same 1e-5 and
top-k, to the exact dot within the worst case of its summation plus the
split's 3 2^-22 sum |q_i f_i|, and to the JAX kernel in interpret mode;
and, the negative control, one TF32 product alone (hi.hi) exceeds 1e-5 on
the same inputs, so the bound catches a lost split.

``wgmma_dots`` models B2 / B3's own walk (video_score_float_kernel): the
feature axis in 128-byte chunks, zero-filled past D as TMA fills them, four
32-byte k-steps a chunk (m64nNk16 bf16, m64nNk8 tf32 with the three
products), the row's first product overwriting the accumulator. It is the
order above bit for bit (so the argument moved with the kernel), within
1e-5 of the plain version at D = 256 and at D = 384 (the f32 64-query
tile), against the JAX kernel in interpret mode, and its single TF32
product breaks the bound there too.

``masked_wgmma_scores`` / ``masked_wgmma_b10`` are B9 / B10 in the order of
masked_score_kernel: each clip's dots by that chunked walk, then the fold
(s * m + (1 - m) * -1e10, each operation rounded in f32) into a running
max from -inf (B9, the two streams averaged) or -1e10 (B10, exp(alpha .)
when asked). Within 1e-5 of video_scores_xla and fused_video_scores_xla at
D = 72 (a tail past a chunk) and 256 with top-k identical outside
near-ties and fully masked videos exactly -1e10, against the JAX kernels
(video_scores_pallas, fused_video_scores_clip_major) in interpret mode,
and one TF32 product alone breaks 1e-5 in both.
"""
import math

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
K_STEP_TF32 = 8             # f32 values of one m16n8k8 k-step


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
    return torch.from_numpy(_adversarial_f32(rng, n, d)).to(torch.bfloat16)


def _adversarial_f32(rng, n, d):
    """The rows of ``_adversarial``, drawn and normalized in f32."""
    rows = np.empty((n, d), np.float32)
    sign = np.where(np.arange(d) % 2, -1.0, 1.0)
    rows[: n // 2] = sign / np.sqrt(d)
    rest = rng.normal(size=(n - n // 2, d)).astype(np.float32) * 0.01
    rest[:, :8] = sign[:8] * 0.35
    rows[n // 2:] = rest
    return rows / np.linalg.norm(rows, axis=-1, keepdims=True)


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


# ------------------------------------------------------------ f32: 3xTF32
def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (held in f32): round to 11 significant bits, ties away
    from zero (half a TF32 ulp added to the magnitude bits, the low 13 bits
    cleared), as cvt.rna.tf32.f32 does for finite x."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def tf32x3_dots(q: torch.Tensor, f: torch.Tensor, terms=("lo_hi", "hi_lo", "hi_hi")):
    """(Nq, D) x (R, D) f32 -> (Nq, R) f32 dots in the kernel's order: per
    k-step of 8, an f32 sum of each product's 8 exact TF32 x TF32 terms in
    order (lo.hi, then hi.lo, then hi.hi), each added to the accumulator.
    ``terms=("hi_hi",)`` is one TF32 product alone."""
    (qh, ql), (fh, fl) = split_tf32(q), split_tf32(f)
    pairs = {"lo_hi": (ql, fh), "hi_lo": (qh, fl), "hi_hi": (qh, fh)}
    acc = torch.zeros((q.shape[0], f.shape[0]), dtype=torch.float32)
    for k0 in range(0, q.shape[1], K_STEP_TF32):
        for t in terms:
            a, b = pairs[t]
            prods = a[:, None, k0:k0 + K_STEP_TF32] * b[None, :, k0:k0 + K_STEP_TF32]
            part = prods[..., 0]
            for i in range(1, prods.shape[-1]):
                part = part + prods[..., i]
            acc = acc + part
    return acc


def tf32x3_scores(qvt, qst, fv, fs, n_videos: int, lp: int, terms=("lo_hi", "hi_lo", "hi_hi")):
    mv, ms = (tf32x3_dots(q.T, f, terms).view(q.shape[1], -1, lp).amax(dim=2)
              for q, f in ((qvt, fv), (qst, fs)))
    return ((mv + ms) / 2)[:, :n_videos]


def _unit_f32(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True))


def _case_f32(d, seed, nq=24, nv=40, lp=8, adversarial=False):
    """The bf16 cases' shapes and adversarial rows, drawn and normalized in
    f32: no value is exact in TF32 by construction."""
    rng = np.random.default_rng(seed)
    q = [_unit_f32(rng, nq, d) for _ in range(2)]
    if adversarial:
        q[0][: nq // 2] = float(1.0 / np.sqrt(d))
        f = [torch.from_numpy(_adversarial_f32(rng, nv * lp, d)) for _ in range(2)]
    else:
        f = [_unit_f32(rng, nv * lp, d) for _ in range(2)]
    return q[0].T, q[1].T, f[0], f[1], nv, lp


def test_rna_tf32_rounds_to_11_bits_ties_away():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 + 2 ** -23, 1 + 2 ** -12,
                      1 + 3 * 2 ** -11, 3.0e-8, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -10, 1.0, 1 + 2 ** -9,
                         float(np.float32(3.0e-8)), 0.0], dtype=torch.float32)
    got = rna_tf32(x)
    assert torch.equal(got[:-2], want[:-2])
    assert got[-1] == 0.0 and abs(got[-2] - want[-2]) <= 2 ** -11 * want[-2]
    x = _unit_f32(np.random.default_rng(0), 4096, 1)[:, 0] * 3.7
    hi, lo = split_tf32(x)
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())     # TF32: low 13 bits zero
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())
    assert torch.equal((x - hi).double(), x.double() - hi.double())  # the subtraction is exact
    assert bool(((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** -22 * x.abs()).all())


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("d", [16, 256])
def test_tf32x3_order_within_the_bound(d, adversarial):
    qvt, qst, fv, fs, nv, lp = _case_f32(d, seed=d + adversarial + 100, adversarial=adversarial)
    model = tf32x3_scores(qvt, qst, fv, fs, nv, lp)
    plain = vs.video_scores_flat_plain(qvt, qst, fv, fs, nv, lp)
    assert model.shape == plain.shape == (qvt.shape[1], nv)
    assert (model - plain).abs().max().item() <= ATOL
    pv, pi = topk_stable(plain, 10)
    _, mi = topk_stable(model, 10)
    assert rank_mismatches(pi.numpy(), pv.numpy(), mi.numpy(), atol=2 * ATOL) == 0


@pytest.mark.parametrize("d", [16, 256])
def test_one_tf32_product_breaks_the_bound(d):
    """The negative control: hi.hi alone on the same f32 inputs is off by
    more than the 1e-5 the kernel is held to, so that check would catch a
    kernel that lost the split."""
    qvt, qst, fv, fs, nv, lp = _case_f32(d, seed=d + 100)
    plain = vs.video_scores_flat_plain(qvt, qst, fv, fs, nv, lp)
    one = tf32x3_scores(qvt, qst, fv, fs, nv, lp, terms=("hi_hi",))
    assert (one - plain).abs().max().item() > ATOL


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("d", [16, 256])
def test_tf32x3_within_the_worst_case(d, adversarial):
    """Each dot of the model against the exact sum: within the worst case of
    summing its 3D terms in f32, (3D - 1) 2^-24 sum |q_i f_i| to first
    order, plus the split's 3 2^-22 sum |q_i f_i|."""
    qvt, _, fv, _, _, _ = _case_f32(d, seed=10 * d + adversarial, adversarial=adversarial)
    q, f = qvt.T, fv
    exact = q.double() @ f.double().T
    mass = q.double().abs() @ f.double().abs().T
    bound = ((3 * d - 1) * 2.0 ** -24 * 1.01 + 3 * 2.0 ** -22) * mass
    assert bool(((tf32x3_dots(q, f).double() - exact).abs() <= bound).all())


def test_tf32x3_against_the_pallas_kernel():
    """The smallest shape crossing the TPU kernel's video tile, in f32: 24
    videos in tiles of 8, D = 16 (two k-steps of 8), lp = 8."""
    qvt, qst, fv, fs, nv, lp = _case_f32(16, seed=3, nq=4, nv=24, lp=8)
    j = lambda t: jnp.asarray(t.numpy())
    pal = np.asarray(jp.video_scores_pallas_flat(j(qvt), j(qst), j(fv), j(fs), nv, lp=lp,
                                                 chunk_v=8, interpret=True))
    model = tf32x3_scores(qvt, qst, fv, fs, nv, lp).numpy()
    assert pal.shape == model.shape == (4, nv)
    np.testing.assert_allclose(model, pal, rtol=0, atol=ATOL)


# ------------------------------------------- B2 / B3's wgmma walk (both kinds)
CHUNK_BYTES = 128           # K bytes of a ring stage: 64 bf16, 32 f32
STEP_BYTES = 32             # K bytes of one wgmma k-step: 16 bf16, 8 tf32


def wgmma_dots(q: torch.Tensor, f: torch.Tensor, terms=("lo_hi", "hi_lo", "hi_hi")):
    """(Nq, D) x (R, D) bf16 or f32 -> (Nq, R) f32 dots in the order of
    video_score_float_kernel: D zero-padded to whole 128-byte chunks, each
    chunk's four k-steps in order; bf16: a k-step's 16 exact products
    summed in f32, then added; f32: per k-step the given products of the
    operands' rna TF32 halves (lo.hi, hi.lo, hi.hi), each an f32 sum of 8
    exact terms added in turn. The first product of the row overwrites the
    accumulator (wgmma's scale-d 0)."""
    size = q.element_size()
    d_pad = -(-q.shape[1] * size // CHUNK_BYTES) * CHUNK_BYTES // size
    pad = lambda x: torch.nn.functional.pad(x.float(), (0, d_pad - x.shape[1]))
    if q.dtype == torch.bfloat16:
        pairs = {"bf16": (pad(q), pad(f))}
        terms = ("bf16",)
    else:
        (qh, ql), (fh, fl) = split_tf32(pad(q)), split_tf32(pad(f))
        pairs = {"lo_hi": (ql, fh), "hi_lo": (qh, fl), "hi_hi": (qh, fh)}
    step = STEP_BYTES // size
    acc = None
    for k0 in range(0, d_pad, step):
        for t in terms:
            a, b = pairs[t]
            prods = a[:, None, k0:k0 + step] * b[None, :, k0:k0 + step]
            part = prods[..., 0]
            for i in range(1, step):
                part = part + prods[..., i]
            acc = part if acc is None else acc + part
    return acc


def wgmma_scores(qvt, qst, fv, fs, n_videos: int, lp: int, terms=("lo_hi", "hi_lo", "hi_hi")):
    mv, ms = (wgmma_dots(q.T, f, terms).view(q.shape[1], -1, lp).amax(dim=2)
              for q, f in ((qvt, fv), (qst, fs)))
    return ((mv + ms) / 2)[:, :n_videos]


def _case_kind(kind, d, seed, **kw):
    return (_case if kind == "bf16" else _case_f32)(d, seed, **kw)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("d", [16, 256, 272, 384])
def test_wgmma_walk_is_the_tensor_core_order(kind, d):
    """The chunked walk sums what the k-step models sum, in their order:
    bit for bit, at one k-step, the model's width, a tail past a chunk and
    the widest feature axis in use."""
    qvt, _, fv, _, _, _ = _case_kind(kind, d, seed=d + 7)
    q, f = qvt.T, fv
    want = tc_order_dots(q, f) if kind == "bf16" else tf32x3_dots(q, f)
    assert torch.equal(wgmma_dots(q, f), want)


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("d", [256, 384])
def test_wgmma_walk_within_the_bound(kind, d, adversarial):
    qvt, qst, fv, fs, nv, lp = _case_kind(kind, d, seed=d + adversarial + 200,
                                          adversarial=adversarial)
    model = wgmma_scores(qvt, qst, fv, fs, nv, lp)
    plain = vs.video_scores_flat_plain(qvt, qst, fv, fs, nv, lp)
    assert model.shape == plain.shape == (qvt.shape[1], nv)
    assert (model - plain).abs().max().item() <= ATOL
    pv, pi = topk_stable(plain, 10)
    _, mi = topk_stable(model, 10)
    assert rank_mismatches(pi.numpy(), pv.numpy(), mi.numpy(), atol=2 * ATOL) == 0


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_wgmma_walk_against_the_pallas_kernel(kind):
    """The smallest shape crossing the TPU kernel's video tile: 24 videos in
    tiles of 8, D = 16 (one k-step of bf16, two of tf32, in one chunk),
    lp = 8."""
    qvt, qst, fv, fs, nv, lp = _case_kind(kind, 16, seed=5, nq=4, nv=24, lp=8)
    if kind == "bf16":
        j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    else:
        j = lambda t: jnp.asarray(t.numpy())
    pal = np.asarray(jp.video_scores_pallas_flat(j(qvt), j(qst), j(fv), j(fs), nv, lp=lp,
                                                 chunk_v=8, interpret=True))
    model = wgmma_scores(qvt, qst, fv, fs, nv, lp).numpy()
    assert pal.shape == model.shape == (4, nv)
    np.testing.assert_allclose(model, pal, rtol=0, atol=ATOL)


@pytest.mark.parametrize("d", [256, 384])
def test_one_tf32_wgmma_product_breaks_the_bound(d):
    """The negative control on the kernel's walk: hi.hi alone is off by
    more than 1e-5 on the f32 inputs the split holds within it."""
    qvt, qst, fv, fs, nv, lp = _case_f32(d, seed=d + 300)
    plain = vs.video_scores_flat_plain(qvt, qst, fv, fs, nv, lp)
    assert (wgmma_scores(qvt, qst, fv, fs, nv, lp) - plain).abs().max().item() <= ATOL
    one = wgmma_scores(qvt, qst, fv, fs, nv, lp, terms=("hi_hi",))
    assert (one - plain).abs().max().item() > ATOL


# --------------------------------- B9 / B10's wgmma walk (both kinds)
NEG = -1e10


def _fold(s, mask, init):
    """s: (Nq, Nv, L) f32 dots, mask (Nv, L): the kernel's fold, each
    operation rounded in f32, the running max from ``init``."""
    m = mask.float()[None]
    folded = (s * m + (1.0 - m) * NEG).amax(dim=2)
    return torch.maximum(folded, torch.tensor(init, dtype=torch.float32))


def masked_wgmma_scores(qv, qs, fv, fs, mask, terms=("lo_hi", "hi_lo", "hi_hi")):
    """B9 in the order of masked_score_kernel: each clip's dots by the
    chunked walk of ``wgmma_dots`` (D in 128-byte chunks zero-filled past
    D, four k-steps a chunk; f32 as the three products), folded from -inf,
    the two streams' maxima averaged. qv / qs: (Nq, D); fv / fs: (Nv, L, D)."""
    nv, n_clips, d = fv.shape
    one = lambda q, f: _fold(wgmma_dots(q, f.reshape(-1, d), terms).view(q.shape[0], nv, n_clips),
                             mask, -math.inf)
    return (one(qv, fv) + one(qs, fs)) / 2


def masked_wgmma_b10(q, f, mask, alpha=None, terms=("lo_hi", "hi_lo", "hi_hi")):
    """B10 the same way on one stream (video-major f), from -1e10, exp(alpha .)."""
    nv, n_clips, d = f.shape
    s = _fold(wgmma_dots(q, f.reshape(-1, d), terms).view(q.shape[0], nv, n_clips), mask, NEG)
    return torch.exp(alpha * s) if alpha is not None else s


def _masked_case(kind, d, seed, nq=24, nv=40, n_clips=8, adversarial=False):
    """The video-score cases' unit rows as (Nv, L, D) caches; 0/1 prefix
    masks, video 3 fully masked."""
    qvt, qst, fv, fs, _, _ = _case_kind(kind, d, seed, nq=nq, nv=nv, lp=n_clips,
                                        adversarial=adversarial)
    rng = np.random.default_rng(seed + 1)
    lengths = torch.from_numpy(rng.integers(1, n_clips + 1, nv))
    mask = (torch.arange(n_clips)[None] < lengths[:, None]).float()
    mask[3] = 0.0
    shape = (nv, n_clips, d)
    return qvt.T.contiguous(), qst.T.contiguous(), fv.view(shape), fs.view(shape), mask


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("d", [72, 256])
def test_masked_wgmma_walk_within_the_bound(kind, d, adversarial):
    """B9 and B10 in the masked kernel's order within 1e-5 of their plain
    versions (video_scores_xla, fused_video_scores_xla), top-10 identical
    outside near-ties, the fully masked video exactly -1e10 in both."""
    from tvretrieval_tpu_torch.ops import fused_score as fsc

    qv, qs, fv, fs, mask = _masked_case(kind, d, seed=d + adversarial + 400,
                                        adversarial=adversarial)
    model = masked_wgmma_scores(qv, qs, fv, fs, mask)
    plain = vs.video_scores_xla(qv, qs, fv, fs, mask)
    assert model.shape == plain.shape == (qv.shape[0], fv.shape[0])
    assert (model - plain).abs().max().item() <= ATOL
    assert bool((model[:, 3] == NEG).all())
    pv, pi = topk_stable(plain, 10)
    _, mi = topk_stable(model, 10)
    assert rank_mismatches(pi.numpy(), pv.numpy(), mi.numpy(), atol=2 * ATOL) == 0
    one = masked_wgmma_b10(qv, fv, mask)
    assert (one - fsc.fused_video_scores_xla(qv, fv, mask)).abs().max().item() <= ATOL
    assert bool((one[:, 3] == NEG).all())


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_masked_wgmma_walk_against_the_pallas_kernels(kind):
    """The smallest shape crossing the TPU kernels' video tiles: 24 videos
    in tiles of 8, 8 clips, D = 16 (one k-step of bf16, two of tf32, in one
    chunk); B9 against video_scores_pallas, B10 (exp and not) against
    fused_video_scores_clip_major, both in interpret mode."""
    from tvretrieval_tpu.ops import pallas_kernels as jk

    qv, qs, fv, fs, mask = _masked_case(kind, 16, seed=9, nq=4, nv=24)
    if kind == "bf16":
        j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    else:
        j = lambda t: jnp.asarray(t.numpy())
    jm = jnp.asarray(mask.numpy())
    pal = np.asarray(jp.video_scores_pallas(j(qv), j(qs), j(fv), j(fs), jm, chunk_v=8,
                                            interpret=True))
    np.testing.assert_allclose(masked_wgmma_scores(qv, qs, fv, fs, mask).numpy(), pal,
                               rtol=0, atol=ATOL)
    for alpha in (None, 20.0):
        pal = np.asarray(jk.fused_video_scores_clip_major(
            j(qv), j(fv.transpose(0, 1).contiguous()), jnp.asarray(mask.T[:, None].numpy()),
            alpha=alpha, block_videos=8, interpret=True))
        model = masked_wgmma_b10(qv, fv, mask, alpha).numpy()
        if alpha is None:
            np.testing.assert_allclose(model, pal, rtol=0, atol=ATOL)
        else:
            np.testing.assert_allclose(model, pal, rtol=3e-4, atol=0)


@pytest.mark.parametrize("d", [72, 256])
def test_one_tf32_masked_product_breaks_the_bound(d):
    """The negative control on the masked kernel's walk: hi.hi alone is off
    by more than 1e-5 on the f32 inputs the split holds within it, in B9
    and in B10."""
    from tvretrieval_tpu_torch.ops import fused_score as fsc

    qv, qs, fv, fs, mask = _masked_case("f32", d, seed=d + 500)
    plain = vs.video_scores_xla(qv, qs, fv, fs, mask)
    assert (masked_wgmma_scores(qv, qs, fv, fs, mask) - plain).abs().max().item() <= ATOL
    one = masked_wgmma_scores(qv, qs, fv, fs, mask, terms=("hi_hi",))
    assert (one - plain).abs().max().item() > ATOL
    plain10 = fsc.fused_video_scores_xla(qv, fv, mask)
    assert (masked_wgmma_b10(qv, fv, mask, terms=("hi_hi",)) - plain10).abs().max().item() > ATOL
