"""The port's offline feature pipelines (tvretrieval_tpu_torch.features)
against the JAX package's, on the same seeded inputs: the host copies
(pooling, srt parsing, the video split, MLM masking) bit for bit; both
extraction loops with a fake backbone, equal HDF5 contents; the text side
on a tiny random RoBERTa (tests/test_lm_finetune.py:29-31's config) whose
Flax weights reach torch through ``convert.flax_roberta_to_state_dict``:
the MLM loss within 1e-6, optax's learning-rate schedule at every step,
five fine-tuning steps within 1e-4 relative, the embedder's last hidden
state within 1e-5; and the two text CLIs on ``--device cpu`` with a
word-level tokenizer built here (no tokenizer ships in the repository)."""
import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.features import lm_finetune as jlm
from tvretrieval_tpu.features import pooling as jpool
from tvretrieval_tpu.features import subtitles as jsub
from tvretrieval_tpu.features import text_features as jtext
from tvretrieval_tpu.features import video_features as jvf
from tvretrieval_tpu.features import video_split as jsplit
from tvretrieval_tpu_torch import features as tfeat
from tvretrieval_tpu_torch.convert import flax_roberta_to_state_dict
from tvretrieval_tpu_torch.features import lm_finetune as tlm
from tvretrieval_tpu_torch.features import pooling as tpool
from tvretrieval_tpu_torch.features import subtitles as tsub
from tvretrieval_tpu_torch.features import text_features as ttext
from tvretrieval_tpu_torch.features import video_features as tvf
from tvretrieval_tpu_torch.features import video_split as tsplit
from _baseline_pairs import one_torch_thread  # noqa: F401


TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=32)

SRT = """1
00:00:01,000 --> 00:00:03,500
<i>Hello there.</i>

2
00:00:04,000 --> 00:00:06,000
General {b}Kenobi!{/b}
Second line.

3
no timestamp here

4
00:01:02.250 --> 00:01:04.000
<font color="red"></font>
"""


@pytest.fixture(scope="module")
def hf():
    """transformers, imported without TensorFlow (which it would otherwise
    load, for seconds, beside Flax)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        import transformers
    return transformers


# ------------------------------------------------------------------ host copies


def test_package_exports_match():
    from tvretrieval_tpu import features as jfeat
    assert tfeat.__all__ == jfeat.__all__


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_pooling_bit_equal(pool):
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(11, 6)).astype(np.float32)
    np.testing.assert_array_equal(tpool.frames_to_clips(frames, 3, pool),
                                  jpool.frames_to_clips(frames, 3, pool))
    for n in (4, 11, 15):
        np.testing.assert_array_equal(tpool.align_lengths(frames, n),
                                      jpool.align_lengths(frames, n))
    streams = [frames, rng.normal(size=(9, 4)).astype(np.float32),
               rng.normal(size=(13, 5)).astype(np.float32)]
    np.testing.assert_array_equal(tpool.normalize_and_concat(streams),
                                  jpool.normalize_and_concat(streams))
    toks = rng.normal(size=(20, 6)).astype(np.float32)
    spans = [(0.0, 1.5), (1.2, 4.4), (4.5, 7.5), (30.0, 33.0)]
    ranges = [(0, 4), (4, 9), (9, 9), (9, 20)]
    np.testing.assert_array_equal(
        tpool.tokens_to_clip_features(toks, spans, ranges, 8, 1.5, pool),
        jpool.tokens_to_clip_features(toks, spans, ranges, 8, 1.5, pool))


def test_subtitles_and_video_split_equal(tmp_path):
    assert tsub.parse_srt(SRT) == jsub.parse_srt(SRT)
    srt_dir = tmp_path / "srt"
    srt_dir.mkdir()
    (srt_dir / "show_s01e01_seg02_clip_00.srt").write_text(SRT)
    (srt_dir / "a.srt").write_text(SRT.split("\n\n")[1])
    (srt_dir / "notes.txt").write_text("ignored")
    outs = []
    for mod, name in ((tsub, "t.jsonl"), (jsub, "j.jsonl")):
        assert mod.subtitles_to_jsonl(str(srt_dir), str(tmp_path / name)) == 2
        outs.append((tmp_path / name).read_text())
    assert outs[0] == outs[1]

    splits = {"train": ["a", "b"], "val": ["c"], "test": []}
    durs = {"a": 10.0, "b": 20.5, "c": 30}
    got = tsplit.build_video_duration_idx(splits, durs, str(tmp_path / "t.json"))
    assert got == jsplit.build_video_duration_idx(splits, durs, str(tmp_path / "j.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def _h5(path):
    with h5py.File(path) as h5:
        return {k: h5[k][()] for k in h5.keys()}


def _assert_same_h5(a, b):
    da, db = _h5(a), _h5(b)
    assert list(da) == list(db)
    for k in da:
        assert da[k].dtype == db[k].dtype == np.float32
        np.testing.assert_array_equal(da[k], db[k])


def test_extraction_with_fake_backbones_equal_h5(tmp_path):
    """Frame batching and clip pooling, the last clip padded with its final
    frame: the same HDF5 datasets from both packages."""
    rng = np.random.default_rng(1)
    videos = {"vid_a": rng.integers(0, 255, (9, 4, 4, 3), np.uint8),
              "vid_b": rng.integers(0, 255, (5, 4, 4, 3), np.uint8),
              "vid_c": rng.integers(0, 255, (1, 4, 4, 3), np.uint8)}
    frame_fn = lambda b: b.reshape(len(b), -1)[:, :7].astype(np.float32) * 0.5
    clip_fn = lambda c: c.reshape(len(c), c.shape[1], -1)[:, :, :5].sum(1).astype(np.float32)
    for pool in ("max", "avg"):
        paths = [str(tmp_path / f"{n}_{pool}.h5") for n in ("t", "j")]
        for mod, path in zip((tvf, jvf), paths):
            mod.extract_clip_features(videos, frame_fn, path, frames_per_clip=3,
                                      pool=pool, batch_size=4)
        _assert_same_h5(*paths)
    paths = [str(tmp_path / f"{n}_i3d.h5") for n in ("t", "j")]
    for mod, path in zip((tvf, jvf), paths):
        assert mod.extract_i3d_clip_features(videos, clip_fn, path, frames_per_clip=4,
                                             batch_size=2) == 3
    _assert_same_h5(*paths)
    assert _h5(paths[0])["vid_a"].shape == (3, 5)


def test_extract_token_features_equal_h5(tmp_path):
    texts = {"101": "a b c", "102": "d e", "7": "f g h i j"}
    L, D = 8, 6
    table = np.random.default_rng(2).normal(size=(3, L, D)).astype(np.float32)

    def encode_fn(batch):
        mask = np.zeros((len(batch), L), np.int64)
        for i, t in enumerate(batch):
            mask[i, :len(t.split()) + 2] = 1
        return np.arange(len(batch) * L).reshape(len(batch), L), mask

    embed_fn = lambda ids, mask: table[:len(ids)] + ids[..., None]
    paths = [str(tmp_path / f"{n}.h5") for n in ("t", "j")]
    for mod, path in zip((ttext, jtext), paths):
        assert mod.extract_token_features(texts, encode_fn, embed_fn, path, batch_size=2) == 3
    _assert_same_h5(*paths)


def test_mask_tokens_bit_equal():
    ids = np.random.default_rng(3).integers(0, 90, size=(64, 16)).astype(np.int64)
    mask = (np.arange(16)[None] < np.random.default_rng(4).integers(4, 17, (64, 1))).astype(
        np.int64)
    outs = [mod.mask_tokens(np.random.default_rng(5), ids, mask, mask_token_id=3,
                            vocab_size=90, special_ids=(0, 1, 2), mask_prob=0.15)
            for mod in (tlm, jlm)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------------ text


@pytest.mark.parametrize("ignored", ["some", "all"])
def test_mlm_loss_matches_jax(ignored):
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3, (3, 7, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (3, 7))
    labels[rng.random((3, 7)) < (0.6 if ignored == "some" else 1.1)] = -100
    ref = float(jlm.mlm_loss_fn(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tlm.mlm_loss_fn(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    if ignored == "all":
        assert got == 0.0


def test_lr_schedule_equals_optax():
    import optax

    s = tlm.MLMSettings(lr=3e-3, warmup_steps=2, total_steps=10)
    ref = optax.warmup_cosine_decay_schedule(0.0, s.lr, s.warmup_steps, s.total_steps)
    rate = tlm.warmup_cosine_lr(s)
    # optax computes the rates in float32, at the scale of lr: a few of its
    # ulps there (2**-20 of lr; near the end of the cosine, 1 + cos cancels)
    tol = dict(rtol=2.0 ** -20, atol=s.lr * 2.0 ** -20)
    for step in range(13):
        np.testing.assert_allclose(rate(step), float(ref(step)), **tol)
    assert rate(0) == 0.0

    for warm, total in ((10, 10), (100, 2)):      # both refuse a decay of no steps
        bad = tlm.MLMSettings(warmup_steps=warm, total_steps=total)
        with pytest.raises(ValueError):
            optax.warmup_cosine_decay_schedule(0.0, bad.lr, warm, total)
        with pytest.raises(ValueError, match="total_steps > warmup_steps"):
            tlm.warmup_cosine_lr(bad)
    assert tlm.warmup_cosine_lr(tlm.MLMSettings(lr=1.0, warmup_steps=0, total_steps=4))(0) == 1.0

    # the rates a LambdaLR hands AdamW, read before each update
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=s.lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: rate(k) / s.lr)
    for step in range(12):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(ref(step)), **tol)
        opt.step()
        sched.step()


@pytest.fixture(scope="module")
def roberta_pair(hf):
    cfg = hf.RobertaConfig(**TINY)
    flax_mlm = hf.FlaxRobertaForMaskedLM(cfg, seed=0)
    return cfg, flax_mlm


def _mlm_batches(n, seed):
    g = np.random.default_rng(seed)
    base = np.tile(np.arange(4, 20, dtype=np.int32), (16, 1))
    out = []
    for _ in range(n):
        ids, labels = jlm.mask_tokens(g, base.copy(), np.ones_like(base), mask_token_id=3,
                                      vocab_size=64, special_ids=(0, 1, 2), mask_prob=0.3)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(base), "labels": labels})
    return out


def test_finetune_mlm_matches_jax(hf, roberta_pair):
    """Five identical batches (the same masks), the JAX optax loop against
    the port's AdamW + LambdaLR loop from the converted weights."""
    cfg, flax_mlm = roberta_pair
    settings = tlm.MLMSettings(lr=3e-3, warmup_steps=2, total_steps=10, batch_size=16)
    batches = _mlm_batches(5, seed=7)
    _, ref = jlm.finetune_mlm(flax_mlm, flax_mlm.params, batches, settings)
    model = hf.RobertaForMaskedLM(cfg)
    model.load_state_dict(flax_roberta_to_state_dict(flax_mlm.params), strict=True)
    model, got = tlm.finetune_mlm(model, batches, settings, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert not model.training


def test_torch_embedder_matches_flax(hf):
    cfg = hf.RobertaConfig(**TINY)
    flax_enc = hf.FlaxRobertaModel(cfg, seed=1)
    enc = hf.RobertaModel(cfg)
    sd = flax_roberta_to_state_dict(flax_enc.params)
    enc.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(8)
    ids = rng.integers(3, 64, (3, 12))
    mask = (np.arange(12)[None] < np.array([[12], [7], [3]])).astype(np.int64)
    ids = np.where(mask == 1, ids, cfg.pad_token_id)
    ref = np.asarray(jax.jit(lambda i, m: flax_enc(input_ids=i, attention_mask=m)
                             .last_hidden_state)(ids, mask))
    got = ttext.make_torch_embed_fn(enc, device="cpu")(ids, mask)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def _tiny_checkpoint(hf, path):
    """A word-level tokenizer and a tiny random masked LM saved as a local
    transformers checkpoint directory."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    words = "the a man woman walks talks into room out of door".split()
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>", "<mask>"] + words)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    fast = hf.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>", cls_token="<s>",
        sep_token="</s>", pad_token="<pad>", unk_token="<unk>", mask_token="<mask>")
    fast.save_pretrained(path)
    torch.manual_seed(0)
    cfg = hf.RobertaConfig(**{**TINY, "vocab_size": len(vocab),
                              "max_position_embeddings": 80})
    hf.RobertaForMaskedLM(cfg).save_pretrained(path)
    return words


def test_text_clis_on_the_cpu(hf, tmp_path, capsys):
    """lm_finetune then text_features, both with --device cpu, on a local
    checkpoint; the embedder's rows are the masked lengths."""
    ckpt, tuned = str(tmp_path / "ckpt"), str(tmp_path / "tuned")
    words = _tiny_checkpoint(hf, ckpt)
    rng = np.random.default_rng(9)
    rows = [{"desc_id": i, "desc": " ".join(rng.choice(words, rng.integers(2, 7)))}
            for i in range(8)]
    ann = tmp_path / "ann.jsonl"
    ann.write_text("".join(json.dumps(r) + "\n" for r in rows))
    # 26 epochs of 4 steps: past MLMSettings' 100 warm-up steps, as the
    # schedule (optax's too) requires
    tlm.main(["--annotations", str(ann), "--model_path", ckpt, "--out_path", tuned,
              "--batch_size", "2", "--n_epochs", "26", "--lr", "1e-3", "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out
    out = str(tmp_path / "q.h5")
    ttext.main(["--annotations", str(ann), "--model_path", tuned, "--out_h5", out,
                "--backend", "flax", "--max_length", "12", "--device", "cpu"])
    got = _h5(out)
    assert sorted(got) == sorted(str(r["desc_id"]) for r in rows)
    for r in rows:
        assert got[str(r["desc_id"])].shape == (len(r["desc"].split()) + 2, 32)


def test_text_clis_refuse_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, flags in ((tlm.main, ["--out_path", str(tmp_path)]),
                        (ttext.main, ["--out_h5", str(tmp_path / "q.h5")])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["--annotations", "a.jsonl", "--model_path", str(tmp_path)] + flags)
