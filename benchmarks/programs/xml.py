"""XML on the port's corpus engine: the program of ``xml_tvr_shipped`` and
``xml_tvr_int8_exact`` (and of every configuration that names no program).

The per-batch entry is ``tvretrieval_tpu_torch.retrieval.engine.
_score_query_batch`` over the corpus cache that the engine's own
``_finish_cache`` assembles from the seed's encoder outputs; the check is
``benchmarks.check.judge`` against the plain reference
``benchmarks.reference.xml_ref``. The harness's module docstring says what
each function is for and when it is called.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmarks import check, synth
from benchmarks.reference.xml_ref import Reference


def _port():
    """The system under test: the port's model and engine entry points."""
    from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
    from tvretrieval_tpu_torch.retrieval.engine import (
        RetrievalConfig, _finish_cache, _score_query_batch)
    return XML, XMLConfig, RetrievalConfig, _finish_cache, _score_query_batch


def build(config: dict, device, seed: int):
    """Set-up of the system under test: the model with the seed's weights,
    and the corpus cache made by the engine's own ``_finish_cache`` from the
    seed's encoder outputs. Returns (model, retrieval config, cache, the
    engine's ``_score_query_batch``)."""
    XML, XMLConfig, RetrievalConfig, finish_cache, score = _port()
    model = XML(XMLConfig(**config["model"])).eval().to(device)
    weights = synth.make_weights(config["model"], device, seed)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    context_side = ("video_input_proj", "sub_input_proj", "video_encoder", "sub_encoder",
                    "video_cross", "sub_cross", "ctx_pos_embed")
    if unexpected or any(not k.startswith(context_side) for k in missing):
        raise RuntimeError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    rcfg = RetrievalConfig(**config["retrieval"])
    corpus = config["corpus"]
    bufs = synth.make_corpus(corpus, config["model"], device, seed)
    cache = finish_cache(model, rcfg, synth.CorpusNames(
        corpus["n_videos"], corpus["n_clips"] * corpus["clip_length"]), bufs)
    del bufs
    return model, rcfg, cache, score


def queries(traffic: dict, config: dict, n_videos: int, device, seed: int, call):
    """Call ``call``'s queries: (features, mask, ground-truth video)."""
    return synth.make_queries(traffic, config["model"], n_videos, device, seed, call)


def call(state, queries, score_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """One call of ``_score_query_batch`` with SVMR, as the engine's
    ``retrieve`` makes it; ``score_fn`` stands in for it where given."""
    model, rcfg, cache, score = state
    q_feat, q_mask, gt = queries
    return (score_fn or score)(
        model, rcfg, q_feat, q_mask, cache.video_feat1, cache.video_feat2, cache.sub_feat1,
        cache.sub_feat2, cache.mask, gt, True, feat2_cat=cache.feat2_cat,
        feat2_cat_scale=cache.feat2_cat_scale)


def token_lengths(traffic: dict, device, seed: int, calls: int) -> List[np.ndarray]:
    """The query token lengths of calls 0 .. calls - 1 (``mfu_pct`` reads
    them)."""
    return synth.token_lengths(traffic, device, seed, calls)


def judge(config: dict, traffic: dict, device, seed: int, queries: list,
          outputs: Dict[str, np.ndarray]) -> Dict[str, float]:
    """``check.judge``'s numbers for the checked calls' ``queries`` and the
    program's ``outputs`` (row-aligned), against the reference drawn again
    from the seed."""
    ref = Reference(synth.make_weights(config["model"], device, seed),
                    synth.make_corpus(config["corpus"], config["model"], device, seed),
                    config["model"], config["retrieval"], config["semantics"])
    feat, mask, gt = (torch.cat(parts) for parts in zip(*queries))
    return check.judge(ref, feat, mask, gt, outputs)
