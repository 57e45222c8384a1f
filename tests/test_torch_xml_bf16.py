"""The port's XML at ``dtype_str="bfloat16"`` against the JAX model at
``dtype_str="bfloat16"`` on the same flax parameters (tests/_xml_pairs.py),
and a few bf16 training steps.

Both keep float32 parameters and round to bf16 at the same cast points
(flax ``dtype=bf16``: every Dense, Conv and LayerNorm output, the
attention probabilities and context, the residual sums, the modular
queries, the span similarity; the einsums accumulate float32 and the losses
are float32). The JAX model is compiled with
``xla_allow_excess_precision=False``: XLA:CPU otherwise keeps fused bf16
chains in float32, so it would round where its fusions end, not where the
model casts.

The bound, argued. On the flagship path from the inputs to the span
logits there are N_CAST = 44 cast points (query: input LayerNorm, Dense
product and bias add, positional LayerNorm, an attention block's 8, the
modular mapping and its queries = 14; context: 4 + 8, then the
cross-attention's 4, its residual sum and LayerNorm, and the second block's
8 = 26; span head: the query Dense's 2, the similarity, the conv = 4). At
each, both sides round the same float32 value up to summation order,
relative delta <= 2^-16 for the sums of <= 256 terms here. That moves the
value across a bf16 rounding boundary (spacing >= 2^-8 relative) with
chance <= 2^-16 / 2^-8 = u, bf16's unit roundoff 2^-8; only then do the
two sides differ, by a bf16 step. By the union bound an output differs
beyond float32 noise (rtol 2e-4) with chance <= N_CAST * u = 0.17: the
share of differing outputs must stay below it. And no output may be
further off than N_CAST bf16 steps: |d| <= N_CAST * 2u * max|ref|.

Negative control: the port's float32 model against the JAX bf16 model
rounds nowhere, so nearly every output differs by about a bf16 step: its
share falls outside the bound, so the test tells the two apart."""
import numpy as np
import pytest
import torch

from _xml_pairs import SIZES, flat, flax_params, jax_outputs, make_batch, port_model, port_outputs
from tvretrieval_tpu.models import xml as jx
from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.models.xml import XMLConfig
from tvretrieval_tpu_torch.training.xml_trainer import TrainSettings, XMLTrainer

U = 2.0 ** -8
N_CAST = 44
NO_EXCESS = {"xla_allow_excess_precision": False}


def _differences(got: dict, want: dict):
    """(share of outputs differing beyond float32 noise, max |d| / max |ref|)
    over every float output; masked -1e10 logits are left out."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    g = np.concatenate([np.ravel(got[k]) for k in want if want[k] is not None])
    w = np.concatenate([np.ravel(want[k]) for k in want if want[k] is not None])
    keep = w > -1e9
    g, w = g[keep].astype(np.float64), w[keep].astype(np.float64)
    differ = ~np.isclose(g, w, rtol=2e-4, atol=1e-6)
    return differ.mean(), np.abs(g - w).max() / np.abs(w).max()


@pytest.fixture(scope="module")
def pair():
    batch = make_batch(seed=3)
    params = flax_params(jx.XMLConfig(**SIZES), batch, seed=4)
    want = jax_outputs(jx.XMLConfig(**SIZES, dtype_str="bfloat16"), params, batch,
                       compiler_options=NO_EXCESS)
    return batch, params, want


def test_bf16_model_matches_jax_bf16_within_the_argued_bound(pair):
    batch, params, want = pair
    model = port_model(dict(SIZES, dtype_str="bfloat16"), params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = port_outputs(model, batch)
    share, rel = _differences(got, want)
    assert share <= N_CAST * U, share
    assert rel <= N_CAST * 2 * U, rel
    # the losses are float32 and agree to float32 noise
    for k in ("loss", "loss.loss_st_ed", "loss.loss_neg_ctx", "loss.loss_neg_q"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6, err_msg=k)


def test_float32_model_falls_outside_the_bf16_bound(pair):
    """Negative control: without the casts the share of differing outputs
    is far above N_CAST * u."""
    batch, params, want = pair
    got = port_outputs(port_model(dict(SIZES), params), batch)
    share, _ = _differences(got, want)
    assert share > N_CAST * U, share


def test_bf16_casts_sit_where_the_flax_model_puts_them(pair):
    batch, params, _ = pair
    model = port_model(dict(SIZES, dtype_str="bfloat16"), params)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        vf1, vf2, sf1, sf2 = model.encode_context(t["video_feat"], t["video_mask"],
                                                  t["sub_feat"], t["sub_mask"])
        vq, sq = model.encode_query(t["query_feat"], t["query_mask"])
        q2c, st, ed = model.get_pred_from_raw_query(
            t["query_feat"], t["query_mask"], vf1, vf2, t["video_mask"], sf1, sf2,
            t["sub_mask"], cross=True)
    assert {x.dtype for x in (vf1, vf2, sf1, sf2, vq, sq)} == {torch.bfloat16}
    assert {x.dtype for x in (q2c, st, ed)} == {torch.float32}   # scores and masked logits


def test_bf16_training_steps_are_finite_and_the_loss_falls():
    world = make_synthetic_world(n_videos=12, n_queries=64, vid_dim=16, text_dim=12,
                                 max_clips=8, seed=5)
    builder = ExampleBuilder(query_source=world.query_source, video_source=world.video_source,
                             sub_source=world.sub_source, ctx_mode="video_sub_tef",
                             max_desc_l=12, max_ctx_l=8, clip_length=world.clip_length)
    cfg = XMLConfig(visual_input_size=18, sub_input_size=14,
                    query_input_size=builder.query_source.dim, hidden_size=16, n_heads=2,
                    max_ctx_l=8, max_desc_l=12, dtype_str="bfloat16")
    trainer = XMLTrainer(cfg, TrainSettings(lr=1e-3, n_epoch=4, bsz=16, seed=1,
                                            prefetch_workers=0),
                         builder, world.annotations, device="cpu")
    losses = [trainer.train_epoch(e)["loss_overall"] for e in range(4)]
    steps = [s["loss_overall"] for s in trainer.last_step_losses]
    assert np.isfinite(losses).all() and np.isfinite(steps).all()
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())   # f32 master
