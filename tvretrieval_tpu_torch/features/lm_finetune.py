"""MLM fine-tuning of a RoBERTa-style LM on single sentences (port of the
JAX package's features/lm_finetune.py).

Capability parity with reference utils/text_feature/
lm_finetuning_on_single_sentences.py's training stage (:317-523): fine-tune
the language model with a masked-LM objective on the dataset's queries
(and/or subtitle sentences) before extracting token features, so the
embeddings adapt to the TV-show domain.

A transformers torch ``...ForMaskedLM`` on the card (or ``device="cpu"``),
AdamW with linear warm-up and cosine decay, 15% dynamic masking (80% mask
/ 10% random / 10% keep, the BERT recipe the reference inherits from HF's
fine-tuning script). The steps match the JAX package's optax loop:

* the rate is optax's ``warmup_cosine_decay_schedule(0, lr, warmup,
  total)`` read at the step count before its increment, so the first
  update has rate 0 (``warmup_cosine_lr``, through a ``LambdaLR``);
* ``torch.optim.AdamW`` is optax's ``adamw`` given the same rates: bias
  correction, eps 1e-8 outside the square root, decay decoupled and on
  every parameter;
* the model stays in eval mode (the JAX step calls it with
  ``train=False``): no dropout while the gradients flow.

No pretrained weights or tokenizer ship in the repository; the loop is
testable with a random-init tiny config.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Tuple

import numpy as np
import torch

from tvretrieval_tpu_torch.utils.device import resolve_device


@dataclass
class MLMSettings:
    lr: float = 5e-5
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 1000
    batch_size: int = 32
    max_length: int = 64
    mask_prob: float = 0.15
    seed: int = 0


def mask_tokens(rng: np.random.Generator, input_ids: np.ndarray,
                attention_mask: np.ndarray, mask_token_id: int,
                vocab_size: int, special_ids: Tuple[int, ...],
                mask_prob: float = 0.15):
    """Dynamic MLM masking: labels = original ids at masked positions,
    -100 elsewhere; 80/10/10 mask/random/keep split."""
    labels = np.full_like(input_ids, -100)
    special = np.isin(input_ids, special_ids)
    candidates = (attention_mask == 1) & ~special
    pick = (rng.random(input_ids.shape) < mask_prob) & candidates
    labels[pick] = input_ids[pick]

    out = input_ids.copy()
    r = rng.random(input_ids.shape)
    out[pick & (r < 0.8)] = mask_token_id
    rand_pick = pick & (r >= 0.8) & (r < 0.9)
    out[rand_pick] = rng.integers(0, vocab_size, size=int(rand_pick.sum()))
    return out, labels


def mlm_loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label != -100; 0 when there is none (the
    JAX loss divides by max(valid, 1), where ``F.cross_entropy`` would
    return NaN)."""
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def warmup_cosine_lr(settings: MLMSettings):
    """Step -> rate: optax ``warmup_cosine_decay_schedule(0, lr,
    warmup_steps, total_steps)`` (end value 0): linear from 0 to ``lr``
    over the warm-up, then cosine to 0 over the remaining steps, and 0
    after them. Like optax, it refuses total_steps <= warmup_steps."""
    lr, warm, total = settings.lr, settings.warmup_steps, settings.total_steps
    decay = total - warm
    if decay <= 0:
        raise ValueError(f"the cosine decay needs total_steps > warmup_steps; got "
                         f"{total} <= {warm}")

    def rate(step: int) -> float:
        if step < warm:
            return lr * step / warm
        t = min(step - warm, decay) / decay
        return lr * 0.5 * (1.0 + math.cos(math.pi * t))

    return rate


def finetune_mlm(model: torch.nn.Module, batches: Iterable[dict],
                 settings: MLMSettings, device=None):
    """Run MLM fine-tuning of a transformers ``...ForMaskedLM`` on
    ``device``; batches yield {input_ids, attention_mask, labels} numpy
    arrays. Returns (model, losses)."""
    dev = resolve_device(device, "finetune_mlm")
    model = model.to(dev).eval()                    # no dropout, as in the JAX step
    optimizer = torch.optim.AdamW(model.parameters(), lr=settings.lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=settings.weight_decay)
    rate = warmup_cosine_lr(settings)
    lr_sched = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: rate(step) / settings.lr if settings.lr else 0.0)
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    losses = []
    for batch in batches:
        logits = model(input_ids=as_dev(batch["input_ids"]),
                       attention_mask=as_dev(batch["attention_mask"])).logits
        loss = mlm_loss_fn(logits, as_dev(batch["labels"]))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        lr_sched.step()
        losses.append(loss.item())
    return model, losses


def make_mlm_batches(sentences: List[str], tokenizer, settings: MLMSettings,
                     n_epochs: int = 1):
    """Tokenize + dynamically mask sentence batches (generator)."""
    rng = np.random.default_rng(settings.seed)
    special_ids = tuple(i for i in (tokenizer.cls_token_id, tokenizer.sep_token_id,
                                    tokenizer.pad_token_id) if i is not None)
    order = np.arange(len(sentences))
    for _ in range(n_epochs):
        rng.shuffle(order)
        for i in range(0, len(order) - settings.batch_size + 1, settings.batch_size):
            chunk = [sentences[j] for j in order[i:i + settings.batch_size]]
            enc = tokenizer(chunk, padding="max_length", truncation=True,
                            max_length=settings.max_length, return_tensors="np")
            ids, labels = mask_tokens(
                rng, enc["input_ids"], enc["attention_mask"],
                tokenizer.mask_token_id, tokenizer.vocab_size, special_ids,
                settings.mask_prob)
            yield {"input_ids": ids, "attention_mask": enc["attention_mask"],
                   "labels": labels}


def main(argv=None):
    import argparse

    from tvretrieval_tpu_torch.utils.io import load_jsonl

    parser = argparse.ArgumentParser(description="MLM fine-tune a local LM")
    parser.add_argument("--annotations", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--n_epochs", type=int, default=1)
    parser.add_argument("--lr", type=float, default=5e-5)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    dev = resolve_device(args.device, "lm_finetune")
    from transformers import AutoModelForMaskedLM, AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    model = AutoModelForMaskedLM.from_pretrained(args.model_path)

    rows = load_jsonl(args.annotations)
    sentences = [r["desc"] for r in rows]
    settings = MLMSettings(lr=args.lr, batch_size=args.batch_size,
                           total_steps=max(len(sentences) // args.batch_size, 1)
                           * args.n_epochs)
    batches = make_mlm_batches(sentences, tokenizer, settings, args.n_epochs)
    model, losses = finetune_mlm(model, batches, settings, dev)
    model.save_pretrained(args.out_path)
    tokenizer.save_pretrained(args.out_path)
    print(f"final loss {losses[-1]:.4f}; saved to {args.out_path}")


if __name__ == "__main__":
    main()
