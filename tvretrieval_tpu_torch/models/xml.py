"""XML (Cross-modal Moment Localization), inference half, in PyTorch.

Port of tvretrieval_tpu/models/xml.py for the flagship configuration
(``bench.py``: video_sub, transformer encoders, cross-attention, one merged
ConvSE conv pair): dual video/subtitle context encoders with
cross-attention (reference model_xml.py:344-375), the modular query
encoder (:399-423), video-level cosine scores (:436-453) and the merged
ConvSE span logits (:455-502), including the corpus-inference form that
gathers top-V similarity rows from one concatenated-cache sweep.

Every other ``XMLConfig`` value raises ``NotImplementedError`` at
construction (ROADMAP A8 ports the variants); training (losses, dropout
schedules) is ROADMAP A7.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from tvretrieval_tpu_torch.models.components import (
    BertAttention,
    BertSelfAttention,
    Conv1dSame,
    LinearLayer,
    TrainablePositionalEncoding,
    init_like_flax,
)
from tvretrieval_tpu_torch.ops.masking import mask_logits


@dataclass(frozen=True)
class XMLConfig:
    """Same fields and defaults as tvretrieval_tpu.models.xml.XMLConfig."""

    ctx_mode: str = "video_sub"
    merge_two_stream: bool = True
    cross_att: bool = True
    span_predictor_type: str = "conv"
    stack_conv_predictor_conv_kernel_sizes: Optional[tuple] = None
    encoder_type: str = "transformer"
    add_pe_rnn: bool = False
    visual_input_size: int = 3074
    sub_input_size: int = 770
    query_input_size: int = 768
    hidden_size: int = 256
    n_heads: int = 4
    conv_kernel_size: int = 5
    max_ctx_l: int = 100
    max_desc_l: int = 30
    input_drop: float = 0.1
    drop: float = 0.1
    margin: float = 0.1
    ranking_loss_type: str = "hinge"
    lw_neg_q: float = 1.0
    lw_neg_ctx: float = 1.0
    no_modular: bool = False
    cross_att_drop: Optional[float] = None
    initializer_range: float = 0.02
    dtype_str: str = "float32"

    @property
    def use_video(self) -> bool:
        return "video" in self.ctx_mode

    @property
    def use_sub(self) -> bool:
        return "sub" in self.ctx_mode

    @property
    def n_streams(self) -> int:
        return int(self.use_video) + int(self.use_sub)


def _check_supported(c: XMLConfig) -> None:
    unsupported = {
        "ctx_mode": c.ctx_mode != "video_sub",
        "merge_two_stream": not c.merge_two_stream,
        "cross_att": not c.cross_att,
        "span_predictor_type": c.span_predictor_type != "conv",
        "stack_conv_predictor_conv_kernel_sizes":
            c.stack_conv_predictor_conv_kernel_sizes is not None,
        "encoder_type": c.encoder_type != "transformer",
        "no_modular": c.no_modular,
        "dtype_str": c.dtype_str != "float32",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"XMLConfig {', '.join(f'{k}={getattr(c, k)!r}' for k in bad)}: the "
            "port covers the flagship video_sub / transformer / cross-att / "
            "merged-conv configuration only (variants: ROADMAP A8)")


def cosine_video_scores(query_vec: torch.Tensor, context_feat1: torch.Tensor,
                        context_mask: torch.Tensor) -> torch.Tensor:
    """Max-over-clips cosine similarity of each query vs each video.

    query_vec (M, D), context_feat1 (N, L, D), context_mask (N, L) ->
    (M, N) scores (reference get_video_level_scores, model_xml.py:436-453).
    """
    q = query_vec / (torch.linalg.norm(query_vec, dim=-1, keepdim=True) + 1e-12)
    f = context_feat1 / (torch.linalg.norm(context_feat1, dim=-1, keepdim=True) + 1e-12)
    scores = torch.einsum("md,nld->mln", q.float(), f.float())
    scores = mask_logits(scores, context_mask.T[None])
    return scores.amax(dim=1)


class XML(nn.Module):
    def __init__(self, cfg: XMLConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = c = cfg
        h = c.hidden_size
        cad = c.drop if c.cross_att_drop is None else c.cross_att_drop
        encoder = lambda: BertAttention(h, c.n_heads, c.drop, c.drop)
        self.query_pos_embed = TrainablePositionalEncoding(c.max_desc_l, h, c.input_drop)
        self.ctx_pos_embed = TrainablePositionalEncoding(c.max_ctx_l, h, c.input_drop)
        self.query_input_proj = LinearLayer(c.query_input_size, h, True, c.input_drop, True)
        self.query_encoder = encoder()
        for stream, in_dim in (("video", c.visual_input_size),
                               ("sub", c.sub_input_size)):
            setattr(self, f"{stream}_input_proj",
                    LinearLayer(in_dim, h, True, c.input_drop, True))
            setattr(self, f"{stream}_encoder1", encoder())
            setattr(self, f"{stream}_encoder2", encoder())
            setattr(self, f"{stream}_cross_att", BertSelfAttention(h, c.n_heads, cad))
            setattr(self, f"{stream}_cross_ln", nn.LayerNorm(h, eps=1e-5))
            setattr(self, f"{stream}_query_linear", nn.Linear(h, h))
        self.modular_vector_mapping = nn.Linear(h, c.n_streams, bias=False)
        self.merged_st_predictor = Conv1dSame(c.conv_kernel_size)
        self.merged_ed_predictor = Conv1dSame(c.conv_kernel_size)

    def init_weights(self, generator: torch.Generator) -> "XML":
        """Seeded initialization with the JAX package's initializers."""
        init_like_flax(self, generator)
        return self

    # ------------------------------------------------------------------ input
    def encode_input(self, feat, mask, proj, encoder, pos_embed):
        """project -> +pos-embed (LN+drop) -> 1 encoder layer
        (reference model_xml.py:377-397)."""
        return encoder(pos_embed(proj(feat)), mask)

    # ------------------------------------------------------------------ query
    def encode_query(self, query_feat, query_mask):
        encoded = self.encode_input(query_feat, query_mask, self.query_input_proj,
                                    self.query_encoder, self.query_pos_embed)
        return self.get_modularized_queries(encoded, query_mask)

    def get_modularized_queries(self, encoded_query, query_mask):
        """Softmax attention pooling into one query vector per stream
        (reference model_xml.py:399-423). Returns (video_query, sub_query)."""
        att = self.modular_vector_mapping(encoded_query)          # (N, L, 2)
        att = torch.softmax(mask_logits(att, query_mask[:, :, None]), dim=1)
        queries = torch.einsum("blm,bld->bmd", att, encoded_query)
        return queries[:, 0], queries[:, 1]

    # ---------------------------------------------------------------- context
    def encode_context(self, video_feat, video_mask, sub_feat, sub_mask):
        """Returns (video_feat1, video_feat2, sub_feat1, sub_feat2); feat1 is
        the retrieval stream, feat2 the localization stream
        (reference model_xml.py:331-355)."""
        ev = self.encode_input(video_feat, video_mask, self.video_input_proj,
                               self.video_encoder1, self.ctx_pos_embed)
        es = self.encode_input(sub_feat, sub_mask, self.sub_input_proj,
                               self.sub_encoder1, self.ctx_pos_embed)
        xv = self._cross_context(ev, video_mask, es, sub_mask, self.video_cross_att,
                                 self.video_cross_ln, self.video_encoder2)
        xs = self._cross_context(es, sub_mask, ev, video_mask, self.sub_cross_att,
                                 self.sub_cross_ln, self.sub_encoder2)
        return ev, xv, es, xs

    def _cross_context(self, main, main_mask, side, side_mask, cross_att, norm,
                       self_att):
        """cross-att(main<-side) + LN residual + self-att layer
        (reference model_xml.py:357-375)."""
        cross_mask = torch.einsum("bm,bn->bmn", main_mask, side_mask)
        residual = norm(cross_att(main, side, side, cross_mask) + main)
        return self_att(residual, main_mask)

    # ------------------------------------------------------------------ spans
    def _merged_span_conv(self, similarity):
        """Merged-stream ConvSE (reference get_merged_st_ed_prob,
        model_xml.py:469-480)."""
        return self.merged_st_predictor(similarity), self.merged_ed_predictor(similarity)

    def merged_st_ed_scores(self, video_query, video_feat2, sub_query, sub_feat2,
                            context_mask, cross: bool = False):
        """Merged-stream span logits (reference :455-502). cross=False:
        per-pair (B, L); cross=True: every query against every video,
        (Nq, Nv, L)."""
        vq = self.video_query_linear(video_query)
        sq = self.sub_query_linear(sub_query)
        if cross:
            sim_v = torch.einsum("md,nld->mnl", vq, video_feat2.float())
            sim_s = torch.einsum("md,nld->mnl", sq, sub_feat2.float())
            mask = context_mask[None]
        else:
            sim_v = torch.einsum("bd,bld->bl", vq, video_feat2.float())
            sim_s = torch.einsum("bd,bld->bl", sq, sub_feat2.float())
            mask = context_mask
        similarity = (sim_v + sim_s) / 2
        st, ed = self._merged_span_conv(similarity)
        return mask_logits(st, mask), mask_logits(ed, mask)

    def merged_st_ed_scores_simgather_cat(self, video_query, sub_query, feat2_cat,
                                          context_mask, gather_idx,
                                          sim_dtype: Optional[torch.dtype] = None):
        """Span logits for each query's selected videos from ONE
        corpus-wide sweep over the concatenated cache
        (feat2_cat = [video_feat2 ; sub_feat2] on the feature axis), then a
        row gather of the (Nq, V, L) similarities.

        The stream merge (sim_v + sim_s) / 2 is folded into the query side
        (halving before the cache-dtype cast is exact). ``sim_dtype``
        (bf16 for engine mode "simsweep_cat_bf16") rounds the stored
        similarity once after f32 accumulation; gathered rows are upcast so
        the conv and softmax run in f32. feat2_cat's clip axis may be
        longer than context_mask's L (RetrievalConfig.span_sim_pad_l): the
        zero pad columns are sliced off before the conv.

        The sweep is one large matrix product, left to ``torch.matmul``
        as the JAX package left it to XLA: on the card a bf16 cache with a
        bf16 ``sim_dtype`` multiplies in bf16 with f32 accumulation (reduced-
        precision reduction is off, see the package docstring) and one
        rounding on store; every other combination multiplies in f32.
        """
        vq = self.video_query_linear(video_query)
        sq = self.sub_query_linear(sub_query)
        qcat = (torch.cat([vq, sq], dim=-1) * 0.5).to(feat2_cat.dtype)
        nv, lp, k = feat2_cat.shape
        flat = feat2_cat.reshape(nv * lp, k)
        if (feat2_cat.is_cuda and feat2_cat.dtype == torch.bfloat16
                and sim_dtype == torch.bfloat16):
            sim = qcat @ flat.T                                    # bf16 out
        else:
            sim = qcat.float() @ flat.float().T
            if sim_dtype is not None:
                sim = sim.to(sim_dtype)
        sim = sim.view(qcat.shape[0], nv, lp)
        rows = torch.arange(sim.shape[0], device=sim.device)[:, None]
        L = context_mask.shape[1]
        similarity = sim[rows, gather_idx][:, :, :L].float()       # (Nq, V, L)
        mask_g = context_mask[gather_idx]
        st, ed = self._merged_span_conv(similarity)
        return mask_logits(st, mask_g), mask_logits(ed, mask_g)
