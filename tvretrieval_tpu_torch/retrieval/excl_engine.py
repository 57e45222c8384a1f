"""ExCL inference engines, PyTorch.

Port of tvretrieval_tpu/retrieval/excl_engine.py.

SVMR (reference excl/inference.py:31-75): span probabilities on the GT
video, joint (st, ed) product under the min/max-length mask, top spans.

VCMR via external VR (reference excl/inference_with_vcmr.py:40-103): ExCL is
early-fusion so it cannot pre-encode a corpus; for each query the top-N
videos of an external VR submission are re-encoded WITH the query, st probs
are scaled by exp(alpha * vr_score), and spans from all N videos are merged
by score with Python's stable sort. (As in the JAX package, and unlike the
reference, clip indices are converted to seconds in the predictions; the
reference emits raw clip indices there, which its own evaluator would
mis-score.)

Runs on the model's device in eval mode; the five LSTMs are cuDNN's and the
span selection is ``ops.span.top_spans_from_probs`` (a stable sort): no
hand kernel lies on this path.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from tvretrieval_tpu_torch.data.datasets import CorpusIndex, ExampleBuilder
from tvretrieval_tpu_torch.models.components import evaluating
from tvretrieval_tpu_torch.models.excl import ExCL
from tvretrieval_tpu_torch.ops.span import min_max_length_mask, top_spans_from_probs
from tvretrieval_tpu_torch.utils.io import load_json

BATCH_KEYS = ("query_feat", "query_mask", "video_feat", "video_mask", "sub_feat", "sub_mask")


@torch.no_grad()
def span_probs(model: ExCL, batch: Dict[str, torch.Tensor]):
    """(st_probs, ed_probs), each (N, Lc) float32, in eval mode."""
    with evaluating(model):
        st, ed = model.span_logits(*(batch[k] for k in BATCH_KEYS))
    return torch.softmax(st.float(), dim=-1), torch.softmax(ed.float(), dim=-1)


def _top_spans(st_p, ed_p, min_l: int, max_l: int, top_n: int):
    lm = torch.from_numpy(min_max_length_mask(st_p.shape[-1], min_l, max_l)).to(st_p.device)
    return [t.cpu().numpy() for t in top_spans_from_probs(st_p, ed_p, lm, top_n)]


def excl_retrieve_svmr(model: ExCL, builder: ExampleBuilder, corpus: CorpusIndex,
                       query_rows: List[dict], clip_length: float = 1.5, query_bsz: int = 50,
                       min_pred_l: int = 2, max_pred_l: int = 16,
                       max_before_nms: int = 200) -> Dict[str, list]:
    device = next(model.parameters()).device
    svmr_res = []
    bsz = min(query_bsz, len(query_rows))
    for i in range(0, len(query_rows), bsz):
        rows = query_rows[i:i + bsz]
        b = builder.build_train_batch(rows, eval_labels=True)
        batch = {k: torch.from_numpy(getattr(b, k)).to(device) for k in BATCH_KEYS}
        st_i, ed_i, scores = _top_spans(*span_probs(model, batch), min_pred_l, max_pred_l,
                                        max_before_nms)
        for qi, row in enumerate(rows):
            vid_idx = corpus.video2idx[row["vid_name"]]
            preds = [[vid_idx, float(s * clip_length), float((e + 1) * clip_length), float(sc)]
                     for s, e, sc in zip(st_i[qi], ed_i[qi], scores[qi])]
            svmr_res.append({"desc_id": row["desc_id"], "desc": row.get("desc", ""),
                             "predictions": preds})
    return {"SVMR": svmr_res}


def load_external_vr_with_scores(path: str, top_n: int = 100) -> Dict[int, list]:
    """{desc_id: [(vid_idx, score), ...]} from a VR submission JSON."""
    sub = load_json(path)
    return {e["desc_id"]: [(p[0], p[3]) for p in e["predictions"][:top_n]]
            for e in sub["VR"]}


def excl_retrieve_vcmr_with_external_vr(
        model: ExCL, builder: ExampleBuilder, corpus: CorpusIndex, query_rows: List[dict],
        external_vr_path: str, clip_length: float = 1.5, top_n_videos: int = 100,
        q2c_alpha: float = 20.0, min_pred_l: int = 2, max_pred_l: int = 16,
        top_n_per_video: int = 50, max_before_nms: int = 200) -> Dict[str, list]:
    device = next(model.parameters()).device
    external = load_external_vr_with_scores(external_vr_path, top_n_videos)
    idx2video = {v: k for k, v in corpus.video2idx.items()}
    dur = dict(zip(corpus.vid_names, corpus.durations))

    vcmr_res = []
    for row in query_rows:
        cands = external.get(row["desc_id"], [])[:top_n_videos]
        if not cands:
            vcmr_res.append({"desc_id": row["desc_id"], "desc": row.get("desc", ""),
                             "predictions": []})
            continue
        names = [idx2video[v] for v, _ in cands]
        ctx = builder.build_context_batch(names, [dur[n] for n in names])
        qf, qm = builder.query(row["desc_id"])
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        n = len(names)
        batch = dict(query_feat=on(qf)[None].repeat(n, 1, 1), query_mask=on(qm)[None].repeat(n, 1),
                     **{k: on(getattr(ctx, k)) for k in BATCH_KEYS[2:]})
        st_p, ed_p = span_probs(model, batch)
        vr_scores = on(np.asarray([s for _, s in cands], np.float32))
        st_p = st_p * torch.exp(q2c_alpha * vr_scores)[:, None]
        st_i, ed_i, span_scores = _top_spans(st_p, ed_p, min_pred_l, max_pred_l,
                                             top_n_per_video)
        preds = []
        for vi, (vid_idx, _) in enumerate(cands):
            preds.extend(
                [vid_idx, float(s * clip_length), float((e + 1) * clip_length), float(sc)]
                for s, e, sc in zip(st_i[vi], ed_i[vi], span_scores[vi]))
        preds.sort(key=lambda r: r[3], reverse=True)
        vcmr_res.append({"desc_id": row["desc_id"], "desc": row.get("desc", ""),
                         "predictions": preds[:max_before_nms]})
    return {"VCMR": vcmr_res}
