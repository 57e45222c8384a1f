"""Query / subtitle text feature extraction (port of the JAX package's
features/text_features.py).

Capability parity with reference utils/text_feature/
lm_finetuning_on_single_sentences.py's *extraction* stage (:524-623): run a
RoBERTa-style encoder over each description (or subtitle sentence stream)
and store per-token contextual embeddings keyed by desc_id / vid_name in
HDF5. (The reference MLM-fine-tunes RoBERTa first, ``features.lm_finetune``;
pass the fine-tuned checkpoint here.)

The embedder runs transformers' torch ``AutoModel`` on the card (or
``device="cpu"``). No model weights or tokenizer ship in the repository and
the machines have no network: pass a local checkpoint directory. The
extraction loop takes its ``encode_fn`` / ``embed_fn`` as arguments, so it
is testable without pretrained weights. transformers is imported only
where a model is loaded.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from tvretrieval_tpu_torch.utils.device import resolve_device


def token_features(texts: Dict[str, str],
                   encode_fn: Callable[[List[str]], Tuple[np.ndarray, np.ndarray]],
                   embed_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                   batch_size: int = 64) -> Iterator[Tuple[str, np.ndarray]]:
    """(key, (n_valid_tokens, D) f32) for every text, in order: batches
    encoded and embedded, each row cut to its attention mask's count."""
    keys = list(texts.keys())
    for i in range(0, len(keys), batch_size):
        chunk = keys[i:i + batch_size]
        ids, mask = encode_fn([texts[k] for k in chunk])
        embs = np.asarray(embed_fn(ids, mask))
        for j, key in enumerate(chunk):
            n = int(mask[j].sum())
            yield str(key), embs[j, :n].astype(np.float32)


def extract_token_features(
    texts: Dict[str, str],
    encode_fn: Callable[[List[str]], Tuple[np.ndarray, np.ndarray]],
    embed_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    out_h5_path: str,
    batch_size: int = 64,
) -> int:
    """Extract (n_valid_tokens, D) embeddings per key into an HDF5 file.

    encode_fn: texts -> (input_ids (B, L), attention_mask (B, L)) fixed L.
    embed_fn: (input_ids, attention_mask) -> (B, L, D) token embeddings.
    Only positions with attention_mask==1 are stored (variable-length rows,
    matching the reference's h5 layout: key -> (n_tokens, 768)).
    """
    import h5py

    with h5py.File(out_h5_path, "w") as h5:
        for key, feats in token_features(texts, encode_fn, embed_fn, batch_size):
            h5.create_dataset(key, data=feats)
    return len(texts)


def make_torch_embed_fn(model: torch.nn.Module, device=None):
    """embed_fn backed by a transformers torch encoder (e.g. ``RobertaModel``)
    on ``device``: numpy ids and mask in, the last hidden state out as
    numpy, without gradients and without dropout."""
    dev = resolve_device(device, "make_torch_embed_fn")
    model = model.to(dev).eval()

    @torch.no_grad()
    def embed_fn(ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        out = model(input_ids=torch.from_numpy(np.asarray(ids, np.int64)).to(dev),
                    attention_mask=torch.from_numpy(np.asarray(mask, np.int64)).to(dev))
        return out.last_hidden_state.float().cpu().numpy()

    return embed_fn


def make_hf_torch_embedder(model_path: str, max_length: int = 64, device=None):
    """(encode_fn, embed_fn) backed by a local transformers checkpoint
    directory (model and tokenizer), the model on ``device``."""
    dev = resolve_device(device, "make_hf_torch_embedder")
    from transformers import AutoModel, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_path)

    def encode_fn(texts: List[str]):
        enc = tokenizer(texts, padding="max_length", truncation=True,
                        max_length=max_length, return_tensors="np")
        return enc["input_ids"], enc["attention_mask"]

    return encode_fn, make_torch_embed_fn(AutoModel.from_pretrained(model_path), dev)


# the JAX package's name for its Flax backend; here it loads the torch model
make_hf_flax_embedder = make_hf_torch_embedder


def main(argv=None):
    import argparse

    from tvretrieval_tpu_torch.utils.io import load_jsonl

    parser = argparse.ArgumentParser(description="extract text token features")
    parser.add_argument("--annotations", type=str, required=True,
                        help="jsonl with desc_id + desc fields")
    parser.add_argument("--model_path", type=str, required=True,
                        help="local HF checkpoint dir (e.g. fine-tuned roberta)")
    parser.add_argument("--out_h5", type=str, required=True)
    parser.add_argument("--backend", type=str, default="flax",
                        choices=["flax", "torch"],
                        help="kept for the JAX CLI's flags: either value loads the "
                             "torch model on --device")
    parser.add_argument("--max_length", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    dev = resolve_device(args.device, "text_features")
    rows = load_jsonl(args.annotations)
    texts = {str(r["desc_id"]): r["desc"] for r in rows}
    encode_fn, embed_fn = make_hf_torch_embedder(args.model_path, args.max_length, dev)
    n = extract_token_features(texts, encode_fn, embed_fn, args.out_h5)
    print(f"wrote {n} entries to {args.out_h5}")


if __name__ == "__main__":
    main()
