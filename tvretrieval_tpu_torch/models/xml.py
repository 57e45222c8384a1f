"""XML (Cross-modal Moment Localization) in PyTorch.

Port of tvretrieval_tpu/models/xml.py: the video and subtitle context
encoders (transformer, CNN, LSTM or GRU layers; reference
model_xml.py:84-93) with or without the cross-attention between the
streams (:344-375), the modular query encoder or its max-pooled
``no_modular`` ablation (:399-423), video-level cosine scores (:436-453),
the span heads (the merged single or stacked ConvSE of :455-502 in its
per-pair, gathered-rows, two-stream sweep, concatenated-sweep and
int8-sweep forms, and the per-stream conv or ``cat_linear`` heads of
:512-551), ``get_pred_from_raw_query``, ``visualization_data``, and the
training forward with its span cross-entropy and in-batch ranking losses
(:212-251, :588-637). Every ``XMLConfig`` the JAX package builds builds
here, single-stream ``ctx_mode`` included.

Compute dtype: ``dtype_str="bfloat16"`` runs every block at bf16 with
float32 parameters, with the casts where the flax model has them (see
models.components): the einsums accumulate float32 and are cast after, and
the losses are float32. Dropout follows ``model.train()`` / ``model.eval()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from tvretrieval_tpu_torch.models.components import (
    BertAttention,
    BertSelfAttention,
    Conv1dSame,
    ConvEncoder,
    Dense,
    LayerNorm,
    LinearLayer,
    TrainablePositionalEncoding,
    init_like_flax,
)
from tvretrieval_tpu_torch.models.rnn import RNNEncoder
from tvretrieval_tpu_torch.ops.masking import mask_logits
from tvretrieval_tpu_torch.ops.video_score import quantize_rows_i8, span_sim_cat_i8
from tvretrieval_tpu_torch.utils import trace


class RNNEncoderLayer(nn.Module):
    """Bidirectional RNN with the (x, mask) interface of the attention
    encoder layers; ``hidden_size`` is split across the two directions
    (JAX xml.py:44-57)."""

    def __init__(self, hidden_size: int, rnn_type: str, dtype: torch.dtype):
        super().__init__()
        self.rnn = RNNEncoder(hidden_size, hidden_size // 2, rnn_type, True, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.rnn(x, mask.sum(dim=-1))[0]


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

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32

    @property
    def merged_spans(self) -> bool:
        """The merged two-stream ConvSE span head; otherwise each stream
        has its own head and their logits are averaged. The JAX model
        takes the merged branch for ``cat_linear`` too and fails there (it
        builds no merged head for it); the port gives ``cat_linear`` its
        per-stream heads, which the JAX model does build."""
        return (self.merge_two_stream and self.use_video and self.use_sub
                and self.span_predictor_type == "conv")


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / (||x|| + 1e-12)`` over the last axis, as the JAX package
    writes it with ``jnp.linalg.norm``. At a dtype narrower than float32
    the norm keeps jnp's roundings: the squares at ``x``'s dtype, their sum
    accumulated in float32 and rounded back, then the square root."""
    if x.dtype == torch.float32:
        norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    else:
        norm = (x * x).sum(dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype).sqrt()
    return x / (norm + 1e-12)


def cosine_video_scores(query_vec: torch.Tensor, context_feat1: torch.Tensor,
                        context_mask: torch.Tensor) -> torch.Tensor:
    """Max-over-clips cosine similarity of each query vs each video.

    query_vec (M, D), context_feat1 (N, L, D), context_mask (N, L) ->
    (M, N) scores (reference get_video_level_scores, model_xml.py:436-453).
    Each side is normalized at its own dtype; the products accumulate f32.
    """
    q, f = l2_normalize(query_vec), l2_normalize(context_feat1)
    scores = mask_logits(_rows_dot(q, f), context_mask[None])      # (M, N, L)
    return scores.amax(dim=-1)


def _rows_dot(q: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """(M, D) x (N, L, D) -> (M, N, L) float32 dots, as one matrix product
    over the (N * L, D) rows: ``torch.einsum`` would copy a corpus-sized
    operand into its own layout first."""
    n, L, d = feat.shape
    return (q.float() @ feat.float().reshape(n * L, d).T).view(q.shape[0], n, L)


class XML(nn.Module):
    def __init__(self, cfg: XMLConfig):
        super().__init__()
        self.cfg = c = cfg
        if c.encoder_type not in ("transformer", "cnn", "lstm", "gru"):
            raise NotImplementedError(f"encoder_type {c.encoder_type}")
        if c.span_predictor_type not in ("conv", "cat_linear"):
            raise NotImplementedError(c.span_predictor_type)
        if c.cross_att and not (c.use_video and c.use_sub):
            raise ValueError("cross_att requires both streams")
        h, dt = c.hidden_size, c.dtype
        cad = c.drop if c.cross_att_drop is None else c.cross_att_drop
        # a module the JAX model never calls has no flax parameters, so the
        # port does not build it: the positional embeddings of RNN encoders
        # without add_pe_rnn, the modular mapping under no_modular, and any
        # span head the model does not use
        if self._uses_pos_embed:
            self.query_pos_embed = TrainablePositionalEncoding(c.max_desc_l, h,
                                                               c.input_drop, dt)
            self.ctx_pos_embed = TrainablePositionalEncoding(c.max_ctx_l, h, c.input_drop, dt)
        self.query_input_proj = LinearLayer(c.query_input_size, h, True, c.input_drop, True, dt)
        self.query_encoder = self._make_encoder()
        streams = (("video", c.visual_input_size, c.use_video),
                   ("sub", c.sub_input_size, c.use_sub))
        for stream, in_dim, used in streams:
            if not used:
                continue
            add = lambda name, module: setattr(self, f"{stream}_{name}", module)
            add("input_proj", LinearLayer(in_dim, h, True, c.input_drop, True, dt))
            add("encoder1", self._make_encoder())
            add("encoder2", self._make_encoder())
            if c.cross_att:
                add("cross_att", BertSelfAttention(h, c.n_heads, cad, dt))
                add("cross_ln", LayerNorm(h, dt))
            elif c.encoder_type == "transformer":
                add("encoder3", self._make_encoder())
            add("query_linear", Dense(h, h, dtype=dt))
            if c.span_predictor_type == "conv" and not c.merged_spans:
                add("st_predictor", Conv1dSame(c.conv_kernel_size, dt))
                add("ed_predictor", Conv1dSame(c.conv_kernel_size, dt))
            elif c.span_predictor_type == "cat_linear":
                for name in ("st_q", "st_ctx", "ed_q", "ed_ctx"):
                    add(name, Dense(h, 1, dtype=dt))
        if not c.no_modular:
            self.modular_vector_mapping = Dense(h, c.n_streams, bias=False, dtype=dt)
        if c.merged_spans:
            ks = c.stack_conv_predictor_conv_kernel_sizes
            if ks is None:
                self.merged_st_predictor = Conv1dSame(c.conv_kernel_size, dt)
                self.merged_ed_predictor = Conv1dSame(c.conv_kernel_size, dt)
            else:
                # named as flax names a list attribute's members
                for i, k in enumerate(ks):
                    setattr(self, f"merged_st_predictors_{i}", Conv1dSame(k, dt))
                    setattr(self, f"merged_ed_predictors_{i}", Conv1dSame(k, dt))
                self.combine_st_conv = Dense(len(ks), 1, bias=False, dtype=dt)
                self.combine_ed_conv = Dense(len(ks), 1, bias=False, dtype=dt)

    @property
    def _uses_pos_embed(self) -> bool:
        """RNN encoders add the positional embedding only under add_pe_rnn
        (reference model_xml.py:393-397)."""
        c = self.cfg
        return c.encoder_type in ("transformer", "cnn") or c.add_pe_rnn

    def _make_encoder(self) -> nn.Module:
        c = self.cfg
        if c.encoder_type == "transformer":
            return BertAttention(c.hidden_size, c.n_heads, c.drop, c.drop, c.dtype)
        if c.encoder_type == "cnn":
            # kernel 5, not the class default of 7 (JAX xml.py:199-200)
            return ConvEncoder(c.hidden_size, kernel_size=5, dropout=c.drop, dtype=c.dtype)
        return RNNEncoderLayer(c.hidden_size, c.encoder_type, c.dtype)

    def init_weights(self, generator: torch.Generator) -> "XML":
        """Seeded initialization with the JAX package's initializers."""
        init_like_flax(self, generator)
        return self

    # ------------------------------------------------------------------ input
    def encode_input(self, feat, mask, proj, encoder, pos_embed):
        """project -> +pos-embed (LN+drop) -> 1 encoder layer
        (reference model_xml.py:377-397); ``pos_embed`` is the attribute's
        name, and RNN encoders skip it unless add_pe_rnn is set."""
        x = proj(feat)
        if self._uses_pos_embed:
            x = getattr(self, pos_embed)(x)
        return encoder(x, mask)

    # ------------------------------------------------------------------ query
    def encode_query(self, query_feat, query_mask):
        encoded = self.encode_input(query_feat, query_mask, self.query_input_proj,
                                    self.query_encoder, "query_pos_embed")
        return self.get_modularized_queries(encoded, query_mask)

    def _modular_attention(self, encoded_query, query_mask):
        """(att (N, L, n_streams) f32, queries (N, n_streams, D) at the
        encoded query's dtype): softmax attention pooling."""
        att = self.modular_vector_mapping(encoded_query)
        att = torch.softmax(mask_logits(att, query_mask[:, :, None]), dim=1)
        if encoded_query.dtype is torch.float32:
            return att, torch.einsum("blm,bld->bmd", att, encoded_query)
        queries = torch.einsum("blm,bld->bmd", att, encoded_query.float())
        return att, queries.to(encoded_query.dtype)

    def get_modularized_queries(self, encoded_query, query_mask):
        """One query vector per stream (reference model_xml.py:399-423):
        (video_query, sub_query). Single-stream models return their one
        vector twice; ``no_modular`` max-pools the tokens instead."""
        if self.cfg.no_modular:
            pooled = mask_logits(encoded_query, query_mask[:, :, None]).amax(dim=1)
            return pooled, pooled
        queries = self._modular_attention(encoded_query, query_mask)[1]
        if self.cfg.n_streams == 2:
            return queries[:, 0], queries[:, 1]
        return queries[:, 0], queries[:, 0]

    # ---------------------------------------------------------------- context
    def encode_context(self, video_feat, video_mask, sub_feat, sub_mask):
        """Returns (video_feat1, video_feat2, sub_feat1, sub_feat2), None for
        a stream the model does not use; feat1 is the retrieval stream,
        feat2 the localization stream (reference model_xml.py:331-355)."""
        c = self.cfg
        if c.cross_att:
            ev = self.encode_input(video_feat, video_mask, self.video_input_proj,
                                   self.video_encoder1, "ctx_pos_embed")
            es = self.encode_input(sub_feat, sub_mask, self.sub_input_proj,
                                   self.sub_encoder1, "ctx_pos_embed")
            xv = self._cross_context(ev, video_mask, es, sub_mask, self.video_cross_att,
                                     self.video_cross_ln, self.video_encoder2)
            xs = self._cross_context(es, sub_mask, ev, video_mask, self.sub_cross_att,
                                     self.sub_cross_ln, self.sub_encoder2)
            return ev, xv, es, xs
        out = []
        for stream, feat, mask, used in (("video", video_feat, video_mask, c.use_video),
                                         ("sub", sub_feat, sub_mask, c.use_sub)):
            if not used:
                out += [None, None]
                continue
            get = lambda name: getattr(self, f"{stream}_{name}")
            f1 = self.encode_input(feat, mask, get("input_proj"), get("encoder1"),
                                   "ctx_pos_embed")
            f2 = get("encoder2")(f1, mask)
            if c.encoder_type == "transformer":
                f2 = get("encoder3")(f2, mask)
            out += [f1, f2]
        return tuple(out)

    def _cross_context(self, main, main_mask, side, side_mask, cross_att, norm,
                       self_att):
        """cross-att(main<-side) + LN residual + self-att layer
        (reference model_xml.py:357-375)."""
        cross_mask = torch.einsum("bm,bn->bmn", main_mask, side_mask)
        residual = norm(cross_att(main, side, side, cross_mask) + main)
        return self_att(residual, main_mask)

    # ------------------------------------------------------------------ spans
    def _merged_span_conv(self, similarity):
        """Single or stacked merged-stream ConvSE (reference
        get_merged_st_ed_prob, model_xml.py:469-480): under stacked kernel
        sizes each size's conv runs over the similarity rows and a bias-free
        linear combines them (JAX xml.py:284-294). Every span path of the
        merged head goes through here."""
        ks = self.cfg.stack_conv_predictor_conv_kernel_sizes
        if ks is None:
            return self.merged_st_predictor(similarity), self.merged_ed_predictor(similarity)
        out = []
        for kind in ("st", "ed"):
            stack = torch.stack([getattr(self, f"merged_{kind}_predictors_{i}")(similarity)
                                 for i in range(len(ks))], dim=-1)
            out.append(getattr(self, f"combine_{kind}_conv")(stack)[..., 0])
        return tuple(out)

    def merged_st_ed_scores(self, video_query, video_feat2, sub_query, sub_feat2,
                            context_mask, cross: bool = False):
        """Merged-stream span logits (reference :455-502). cross=False:
        per-pair (B, L); cross=True: every query against every video,
        (Nq, Nv, L). The similarity accumulates f32 and is cast to the
        cache's dtype before the conv, as in the JAX model."""
        if not self.cfg.merged_spans:
            raise ValueError("merged_st_ed_scores needs the merged conv span head")
        vq = self.video_query_linear(video_query).float()
        sq = self.sub_query_linear(sub_query).float()
        dot = _rows_dot if cross else lambda q, f: torch.einsum("bd,bld->bl", q, f.float())
        sim_v, sim_s = dot(vq, video_feat2), dot(sq, sub_feat2)
        mask = context_mask[None] if cross else context_mask
        similarity = ((sim_v + sim_s) / 2).to(video_feat2.dtype)
        st, ed = self._merged_span_conv(similarity)
        return mask_logits(st, mask), mask_logits(ed, mask)

    def merged_st_ed_scores_gathered(self, video_query, video_feat2_g, sub_query,
                                     sub_feat2_g, mask_g):
        """Span logits on per-query GATHERED video rows (engine span mode
        "gather"): equal to ``merged_st_ed_scores(..., cross=True)``
        followed by a row gather, since the conv and the mask act per row.

        video_query / sub_query (Nq, D); video_feat2_g / sub_feat2_g
        (Nq, V, L, D) at the cache dtype; mask_g (Nq, V, L). The queries
        are cast to the cache dtype, the products accumulate in f32.
        Returns masked st, ed logits (Nq, V, L)."""
        vq = self.video_query_linear(video_query).to(video_feat2_g.dtype)
        sq = self.sub_query_linear(sub_query).to(sub_feat2_g.dtype)
        sim_v = torch.einsum("qd,qvld->qvl", vq.float(), video_feat2_g.float())
        sim_s = torch.einsum("qd,qvld->qvl", sq.float(), sub_feat2_g.float())
        with trace.span("span_head"):
            st, ed = self._merged_span_conv((sim_v + sim_s) / 2)
            return mask_logits(st, mask_g), mask_logits(ed, mask_g)

    def _finish_span_logits(self, sim, context_mask, gather_idx):
        """Gather each query's rows ``gather_idx`` of a corpus-wide
        (Nq, Nv, >= L) similarity, cut the clip axis to the mask's L, and
        run the ConvSE conv and the mask on the (Nq, V, L) f32 rows: the
        span "span_head" (utils/trace.py)."""
        with trace.span("span_head"):
            rows = torch.arange(sim.shape[0], device=sim.device)[:, None]
            L = context_mask.shape[1]
            similarity = sim[rows, gather_idx][:, :, :L].float()
            mask_g = context_mask[gather_idx]
            st, ed = self._merged_span_conv(similarity)
            return mask_logits(st, mask_g), mask_logits(ed, mask_g)

    def merged_st_ed_scores_simgather(self, video_query, video_feat2, sub_query,
                                      sub_feat2, context_mask, gather_idx):
        """Span logits of each query's selected videos from a corpus-wide
        similarity sweep per stream and a row gather of the similarities
        (engine span mode "simsweep"; JAX xml.py:359-398). Equal to
        ``merged_st_ed_scores_gathered`` on rows ``gather_idx`` up to the
        summation order of the products: the stream merge (v + s) / 2 runs
        after the gather on f32 values, and the conv and mask act per row.
        The queries are cast to the cache dtype; the sweeps are matrix
        products in f32, one block of videos at a time."""
        sims = []
        for q, feat2 in ((self.video_query_linear(video_query), video_feat2),
                         (self.sub_query_linear(sub_query), sub_feat2)):
            nv, L, d = feat2.shape
            sim = _blocked_sweep(q.to(feat2.dtype).float(), feat2.reshape(nv * L, d), L)
            rows = torch.arange(sim.shape[0], device=sim.device)[:, None]
            sims.append(sim.view(-1, nv, L)[rows, gather_idx])          # (Nq, V, L)
        with trace.span("span_head"):
            mask_g = context_mask[gather_idx]
            st, ed = self._merged_span_conv((sims[0] + sims[1]) / 2)
            return mask_logits(st, mask_g), mask_logits(ed, mask_g)

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
        return self._finish_span_logits(sim.view(qcat.shape[0], nv, lp), context_mask,
                                        gather_idx)

    def _quantized_cat_query(self, video_query, sub_query):
        """The halved concatenated query vectors quantized per query:
        (q8 (Nq, 2D) int8, q_scale (Nq, 1) f32). The JAX source writes the
        quantizer out inline (xml.py:480-482); it is ``quantize_rows_i8``,
        whose scale multiplies by f32(1/127) as XLA compiles the division
        by 127, and whose rounding divides by the scale tensor."""
        vq = self.video_query_linear(video_query)
        sq = self.sub_query_linear(sub_query)
        q8, q_scale = quantize_rows_i8(torch.cat([vq, sq], dim=-1).float() * 0.5)
        return q8, q_scale[:, None]

    def merged_st_ed_scores_simgather_cat_i8(self, video_query, sub_query, feat2_cat_i8,
                                             feat2_scale, context_mask, gather_idx):
        """``merged_st_ed_scores_simgather_cat`` over the int8 concatenated
        cache (engine span mode "simsweep_cat_int8"; JAX xml.py:454-491).

        feat2_cat_i8 (Nv, L, 2D) int8 with feat2_scale (Nv, L) f32 come from
        ``quantize_rows_i8``; the halved query vectors quantize per query
        here. The corpus-wide integer dots run as f32 matrix products, one
        block of videos at a time, which is exact (every partial sum is an
        integer below 2^24 for 2D <= 1040); the gathered (Nq, V, L) dots
        are rescaled as s * (q_scale * f_scale). Not a parity mode: the
        two input roundings are the approximation."""
        q8, q_scale = self._quantized_cat_query(video_query, sub_query)
        nv, L, k = feat2_cat_i8.shape
        if k * 127 * 127 >= 2 ** 24:
            raise ValueError(f"2D={k}: the integer dots are exact in f32 only for 2D <= 1040")
        sim = _blocked_sweep(q8.float(), feat2_cat_i8.reshape(nv * L, k), L)
        with trace.span("span_head"):
            rows = torch.arange(sim.shape[0], device=sim.device)[:, None]
            g = sim.view(-1, nv, L)[rows, gather_idx]                  # (Nq, V, L)
            similarity = g * (q_scale[:, None] * feat2_scale[gather_idx])
            mask_g = context_mask[gather_idx]
            st, ed = self._merged_span_conv(similarity)
            return mask_logits(st, mask_g), mask_logits(ed, mask_g)

    def merged_st_ed_scores_pallas_cat_i8(self, video_query, sub_query, f8_flat,
                                          f_scales, context_mask, gather_idx):
        """``merged_st_ed_scores_simgather_cat_i8`` with the corpus-wide
        sweep run by the span-similarity kernel B5 (engine span mode
        "simsweep_cat_int8_flat"; JAX xml.py:493-537; "pallas" in the name
        means the CUDA kernel, as in the engine's modes).

        f8_flat (Nv_pad * lp, 2D) int8 and f_scales (Nv_pad, lp) f32 come
        from ``ops.video_score.build_flat_feat2_i8``. ``span_sim_cat_i8``
        writes the similarity as bf16 in (Nq, Nv_pad, lp); its s32 dots
        never reach device memory. The same integer dot as
        "simsweep_cat_int8", rescaled as (s * q_scale) * f_scale and rounded
        once to bf16; the gathered rows are upcast, so the conv and softmax
        run in f32. Not a parity mode."""
        q8, q_scale = self._quantized_cat_query(video_query, sub_query)
        sim = span_sim_cat_i8(q8, q_scale, f8_flat, f_scales, lp=f_scales.shape[1])
        return self._finish_span_logits(sim, context_mask, gather_idx)

    def single_stream_st_ed_scores(self, query, feat2, mask, stream: str,
                                   cross: bool = False):
        """One stream's span logits (reference _get_st_ed_prob :512-551):
        the stream's ConvSE pair over its similarity (cast to feat2's
        dtype, as the JAX model casts it), or under ``cat_linear`` a query
        term plus a clip term. cross=False: (B, L); cross=True: (Nq, Nv, L)."""
        c = self.cfg
        get = lambda name: getattr(self, f"{stream}_{name}")
        q = get("query_linear")(query)
        if c.span_predictor_type == "conv":
            sim = (_rows_dot(q, feat2) if cross
                   else torch.einsum("bd,bld->bl", q.float(), feat2.float())).to(feat2.dtype)
            st, ed = get("st_predictor")(sim), get("ed_predictor")(sim)
        else:
            st_q, ed_q = get("st_q")(q), get("ed_q")(q)                  # (Nq, 1)
            st_ctx, ed_ctx = get("st_ctx")(feat2)[..., 0], get("ed_ctx")(feat2)[..., 0]
            if cross:
                st, ed = st_q[:, :, None] + st_ctx[None], ed_q[:, :, None] + ed_ctx[None]
            else:
                st, ed = st_q + st_ctx, ed_q + ed_ctx
        if cross:
            mask = mask[None]
        return mask_logits(st, mask), mask_logits(ed, mask)

    # ------------------------------------------------------------- prediction
    def get_pred_from_raw_query(self, query_feat, query_mask, video_feat1, video_feat2,
                                video_mask, sub_feat1, sub_feat2, sub_mask,
                                cross: bool = False):
        """(q2ctx_scores, st_logits, ed_logits) (reference
        model_xml.py:553-586): the mean over the model's streams of the
        video scores, and the merged span head or the mean of the
        per-stream ones. cross=False: in-batch pairs, q2ctx (N, N), spans
        (N, L); cross=True: all queries against all videos, q2ctx (Nq, Nv),
        spans (Nq, Nv, L). A stream the model does not use may be None."""
        c = self.cfg
        video_query, sub_query = self.encode_query(query_feat, query_mask)
        v_scores = cosine_video_scores(video_query, video_feat1, video_mask) if c.use_video else 0
        s_scores = cosine_video_scores(sub_query, sub_feat1, sub_mask) if c.use_sub else 0
        q2ctx = (v_scores + s_scores) / c.n_streams
        if c.merged_spans:
            st, ed = self.merged_st_ed_scores(video_query, video_feat2, sub_query,
                                              sub_feat2, video_mask, cross)
            return q2ctx, st, ed
        vst, ved = (self.single_stream_st_ed_scores(video_query, video_feat2, video_mask,
                                                    "video", cross)
                    if c.use_video else (0, 0))
        sst, sed = (self.single_stream_st_ed_scores(sub_query, sub_feat2, sub_mask, "sub",
                                                    cross)
                    if c.use_sub else (0, 0))
        return q2ctx, (vst + sst) / c.n_streams, (ved + sed) / c.n_streams

    # --------------------------------------------------------- visualization
    @torch.no_grad()
    def visualization_data(self, query_feat, query_mask, video_feat, video_mask,
                           sub_feat, sub_mask) -> Dict[str, torch.Tensor]:
        """Per-example introspection tensors (reference
        get_visualization_data, model_xml.py:253-289): the modular attention
        over the query tokens, the merged st / ed probabilities and the
        per-stream span similarities; the host slices each by its true
        length. Defined, as in the JAX model, for the merged conv head with
        the modular query only. Runs as in eval mode (no dropout)."""
        c = self.cfg
        if not (c.merged_spans and not c.no_modular):
            raise ValueError("visualization_data needs the merged conv span head and "
                             "the modular query")
        training = self.training
        self.eval()
        try:
            vf1, vf2, sf1, sf2 = self.encode_context(video_feat, video_mask, sub_feat,
                                                     sub_mask)
            encoded = self.encode_input(query_feat, query_mask, self.query_input_proj,
                                        self.query_encoder, "query_pos_embed")
            att, queries = self._modular_attention(encoded, query_mask)
            vql = self.video_query_linear(queries[:, 0]).float()
            sql = self.sub_query_linear(queries[:, 1]).float()
            sim_v = torch.einsum("bd,bld->bl", vql, vf2.float())
            sim_s = torch.einsum("bd,bld->bl", sql, sf2.float())
            similarity = ((sim_v + sim_s) / 2).to(vf2.dtype)
            st_raw, ed_raw = self._merged_span_conv(similarity)
            st, ed = mask_logits(st_raw, video_mask), mask_logits(ed_raw, video_mask)
        finally:
            self.train(training)
        return dict(modular_att_scores=att,
                    st_prob=torch.softmax(st.float(), dim=-1),
                    ed_prob=torch.softmax(ed.float(), dim=-1),
                    similarity_scores=similarity, video_similarity=sim_v,
                    sub_similarity=sim_s)

    # --------------------------------------------------------------- training
    def forward(self, query_feat, query_mask, video_feat, video_mask, sub_feat,
                sub_mask, st_ed_indices, lw_st_ed: float = 0.01,
                neg_sample_upper: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                neg_ranks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Training forward: total loss and the per-loss dict (reference
        model_xml.py:212-251).

        lw_st_ed: span-loss weight (0 before train_span_start_epoch).
        neg_sample_upper: exclusive upper bound of the sampled negative
        *rank*; the batch size when hard negatives are off,
        1 + hard_pool_size once they are on (reference :608-624). It is
        clamped to the actual batch size, which matters for a smaller
        final batch.
        generator: draws the negative ranks in training mode (None: the
        global generator); in eval mode a fixed seed is used, so the eval
        loss does not depend on the caller's random state.
        neg_ranks: optional ((N,) ctx ranks, (N,) query ranks) taking the
        place of the draw (tests inject the ranks another framework drew).
        """
        return self.forward_shard(query_feat, query_mask, video_feat, video_mask, sub_feat,
                                  sub_mask, st_ed_indices, None, 0, 1, lw_st_ed=lw_st_ed,
                                  neg_sample_upper=neg_sample_upper, generator=generator,
                                  neg_ranks=neg_ranks)

    def forward_shard(self, query_feat, query_mask, video_feat, video_mask, sub_feat,
                      sub_mask, st_ed_indices, gather: Optional[Callable], rank: int,
                      world: int,
                      lw_st_ed: float = 0.01, neg_sample_upper: Optional[int] = None,
                      generator: Optional[torch.Generator] = None,
                      neg_ranks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """This rank's share of the GLOBAL-batch training loss, for
        data-parallel training over ``world`` ranks, each holding its
        b = B / world rows (rank r: global rows r * b ... (r + 1) * b - 1).
        The shares sum over the ranks to ``forward`` on the global batch.

        ``gather(x)`` returns every rank's x concatenated on axis 0 in rank
        order, with autograd (a gradient flows back to the rank that owns
        each row); ``forward`` is the case world = 1, gather None. The
        in-batch ranking losses need rows and columns of
        the (B, B) query-by-context score matrix: this rank's b queries
        against every context (the gathered feat1 and masks) for the
        context negatives, and every query (the gathered query vectors)
        against its b contexts for the query negatives. The negative ranks
        are drawn for all B rows from ``generator``, which holds the same
        state on every rank, and this rank takes its b; ``neg_ranks`` are
        the global (B,) vectors when given. The ranking terms are sums over
        the rank's rows divided by B, and the span loss, a per-row mean, is
        the rank's mean divided by ``world``. Returns (loss, loss dict) of
        this rank's share."""
        c = self.cfg
        b = query_feat.shape[0]
        B = b * world
        vf1, vf2, sf1, sf2 = self.encode_context(video_feat, video_mask, sub_feat, sub_mask)
        video_query, sub_query = self.encode_query(query_feat, query_mask)
        if c.merged_spans:
            st_logits, ed_logits = self.merged_st_ed_scores(
                video_query, vf2, sub_query, sf2, video_mask, False)
        else:
            vst, ved = (self.single_stream_st_ed_scores(video_query, vf2, video_mask, "video")
                        if c.use_video else (0, 0))
            sst, sed = (self.single_stream_st_ed_scores(sub_query, sf2, sub_mask, "sub")
                        if c.use_sub else (0, 0))
            st_logits, ed_logits = (vst + sst) / c.n_streams, (ved + sed) / c.n_streams
        loss_st_ed = (_cross_entropy(st_logits.float(), st_ed_indices[:, 0])
                      + _cross_entropy(ed_logits.float(), st_ed_indices[:, 1])) / world

        rows = cols = 0                      # (b, B): q2ctx[mine, :] and q2ctx[:, mine].T
        for used, q, f1, m in ((c.use_video, video_query, vf1, video_mask),
                               (c.use_sub, sub_query, sf1, sub_mask)):
            if used:
                rows = rows + cosine_video_scores(q, f1 if world == 1 else gather(f1),
                                                  m if world == 1 else gather(m))
                if world > 1:
                    cols = cols + cosine_video_scores(gather(q), f1, m).T
        rows = (rows / c.n_streams).float()
        cols = rows.T if world == 1 else (cols / c.n_streams).float()

        upper = B if neg_sample_upper is None else min(int(neg_sample_upper), B)
        if not self.training and generator is None:
            generator = torch.Generator().manual_seed(0)
        if neg_ranks is None:
            neg_ranks = draw_negative_ranks(B, upper, generator, rows.device)
        loss_neg_ctx, loss_neg_q = _ranking_losses(
            rows, cols, rank * b, tuple(r.to(rows.device)[rank * b:(rank + 1) * b]
                                        for r in neg_ranks),
            c.margin, c.ranking_loss_type, B)
        loss = lw_st_ed * loss_st_ed + c.lw_neg_ctx * loss_neg_ctx + c.lw_neg_q * loss_neg_q
        return loss, {
            "loss_st_ed": lw_st_ed * loss_st_ed,
            "loss_neg_ctx": c.lw_neg_ctx * loss_neg_ctx,
            "loss_neg_q": c.lw_neg_q * loss_neg_q,
            "loss_overall": loss,
        }


def _blocked_sweep(q: torch.Tensor, flat: torch.Tensor, L: int,
                   block_videos: int = 2048) -> torch.Tensor:
    """(Nq, K) f32 queries x (Nv * L, K) cache rows of any dtype ->
    (Nq, Nv * L) f32 products, the cache upcast one block of videos at a
    time so that no f32 copy of it exists."""
    out = torch.empty((q.shape[0], flat.shape[0]), dtype=torch.float32, device=q.device)
    step = block_videos * L
    for r0 in range(0, flat.shape[0], step):
        out[:, r0:r0 + step] = q @ flat[r0:r0 + step].float().T
    return out


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels[:, None].long()).mean()


def draw_negative_ranks(n: int, neg_sample_upper: int,
                        generator: Optional[torch.Generator],
                        device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two (n,) int64 rank vectors, uniform on [1, max(neg_sample_upper, 2)),
    for the context and the query negatives, on ``device``. The draw runs
    on the generator's own device (the CPU for the global generator) and
    is copied over, so it never waits for the device."""
    gen_dev = generator.device if generator is not None else "cpu"
    ranks = torch.randint(1, max(int(neg_sample_upper), 2), (2, n),
                          generator=generator, device=gen_dev)
    ranks = ranks.to(device, non_blocking=True)
    return ranks[0], ranks[1]


def video_level_ranking_losses(scores: torch.Tensor,
                               generator: Optional[torch.Generator], margin: float,
                               loss_type: str, neg_sample_upper: int,
                               ranks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """In-batch ranking losses with randomized (optionally hard) negatives.

    scores: (N, N) cosine similarities, diagonal = positives. For each row
    a negative is drawn uniformly from ranks [1, neg_sample_upper) of the
    descending-sorted row (the diagonal pinned to rank 0 by a +999 mask),
    then a hinge or LSE loss pushes the positive above it (reference
    model_xml.py:588-637). The sort is stable, so tied scores rank by
    ascending index, as ``jnp.argsort(-s)`` ranks them. ``ranks``: the
    (ctx, query) rank vectors to use instead of drawing them.
    """
    n = scores.shape[0]
    if ranks is None:
        ranks = draw_negative_ranks(n, neg_sample_upper, generator, scores.device)
    return _ranking_losses(scores, scores.T, 0, ranks, margin, loss_type, n)


def _ranking_losses(rows: torch.Tensor, cols: torch.Tensor, offset: int,
                    ranks: Tuple[torch.Tensor, torch.Tensor], margin: float,
                    loss_type: str, n: int):
    """The two ranking losses' terms of b rows of an (n, n) score matrix,
    summed and divided by n: ``rows`` (b, n) = scores[offset:offset + b],
    ``cols`` (b, n) = scores[:, offset:offset + b].T, ``ranks`` their (ctx,
    query) rank vectors. Rank 0 is the positive, scores[i, i]."""
    b = rows.shape[0]
    diag = torch.arange(b, device=rows.device) + offset
    eye = torch.zeros_like(rows)
    eye[torch.arange(b, device=rows.device), diag] = 1.0
    pos = rows.gather(1, diag[:, None])[:, 0]

    def negatives(s, r):                      # rank 0 = the diagonal
        order = torch.sort(-(s * (1 - eye) + eye * 999.0), dim=1, stable=True).indices
        return s.gather(1, order.gather(1, r.long()[:, None]))[:, 0]

    def rank_loss(ng):
        if loss_type == "hinge":
            return torch.clamp_min(margin + ng - pos, 0.0).sum() / n
        if loss_type == "lse":
            return torch.log1p(torch.exp(ng - pos)).sum() / n
        raise NotImplementedError(loss_type)

    return rank_loss(negatives(rows, ranks[0])), rank_loss(negatives(cols, ranks[1]))
