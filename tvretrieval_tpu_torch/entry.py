"""The flagship XML's forward step with example inputs.

Port of ``__graft_entry__.py::entry``. ``entry()`` returns ``(fn, args)``:
``fn(*args)`` is the eval-mode training loss of the flagship XML at full
width (``video_sub``, inputs 3,074 / 770 / 768, hidden 256, 4 heads, 100
clips, 30 words) on a batch of 8, with ``lw_st_ed=0.01`` and
``neg_sample_upper=8``. ``args[0]`` is the model's parameters as a state
dict, applied with ``torch.func.functional_call``, so that other weights
(e.g. the JAX package's, through ``convert.flax_params_to_state_dict``)
can be passed in their place. The inputs are drawn from
``numpy.random.default_rng(0)`` in the JAX function's order, so both
functions see the same batch; the weights are seeded here
(``XML.init_weights``).

Usage:
    from tvretrieval_tpu_torch.entry import entry
    fn, args = entry()            # on the CUDA card; entry(device="cpu") on the CPU
    loss = fn(*args)

It runs on the CUDA card unless ``device="cpu"`` is given, and exits at
once when there is no card.
"""
from __future__ import annotations

import numpy as np
import torch

from tvretrieval_tpu_torch.models.xml import XML, XMLConfig

B = 8


def entry(device=None):
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("entry: no CUDA device is available; pass device='cpu' to run "
                         "on the CPU")
    cfg = XMLConfig(ctx_mode="video_sub", visual_input_size=3074, sub_input_size=770,
                    query_input_size=768, hidden_size=256, n_heads=4, max_ctx_l=100,
                    max_desc_l=30)
    model = XML(cfg).init_weights(torch.Generator().manual_seed(0)).eval().to(dev)

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    batch = dict(
        query_feat=f32(rng.normal(size=(B, 30, 768))),
        query_mask=f32(np.ones((B, 30))),
        video_feat=f32(rng.normal(size=(B, 100, 3074))),
        video_mask=f32(np.ones((B, 100))),
        sub_feat=f32(rng.normal(size=(B, 100, 770))),
        sub_mask=f32(np.ones((B, 100))),
        st_ed_indices=torch.from_numpy(rng.integers(0, 50, size=(B, 2)).astype(np.int32)).to(dev),
    )

    def forward(params, query_feat, query_mask, video_feat, video_mask, sub_feat, sub_mask,
                st_ed_indices, neg_ranks=None):
        """The eval-mode loss; ``neg_ranks`` as in ``XML.forward``."""
        loss, _ = torch.func.functional_call(
            model, params, (query_feat, query_mask, video_feat, video_mask, sub_feat,
                            sub_mask, st_ed_indices),
            dict(lw_st_ed=0.01, neg_sample_upper=8, neg_ranks=neg_ranks))
        return loss

    params = {k: v.detach() for k, v in model.state_dict().items()}
    return forward, (params, *batch.values())
