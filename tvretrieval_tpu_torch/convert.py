"""Flax parameter tree -> PyTorch ``state_dict`` for the port's modules.

The inverse of the torch->flax map the JAX package's tests use to load the
reference model (tests/test_xml.py:334-398): module paths join with ".",
and leaves map by name:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
- Conv ``kernel`` (*spatial, in, out) -> ``weight`` (out, in, *spatial),
  for 1-d, 2-d and 3-d convolutions;
- LayerNorm and BatchNorm ``scale`` -> ``weight``; ``bias``,
  ``pos_embed`` and NetVLAD's raw ``clusters`` (D, K) / ``clusters2``
  (1, D, K) unchanged (they are parameters, not Dense kernels: not
  transposed);
- a recurrent cell (flax 0.12 ``OptimizedLSTMCell`` / ``GRUCell``: one
  Dense per gate) -> the ``nn.LSTM`` / ``nn.GRU`` tensors of
  ``models.rnn``, gates stacked in torch's order. LSTM: ``weight_ih`` =
  [ii; if; ig; io]^T, ``weight_hh`` = [hi; hf; hg; ho]^T, ``bias_hh`` the
  h-biases, ``bias_ih`` zero (flax has no input bias). GRU, in [r; z; n]
  order: ``bias_ih`` = [ir; iz; in], ``bias_hh`` = [0; 0; hn] (flax has no
  hr / hz bias). A bidirectional encoder's ``fwd_cell`` / ``bwd_cell`` and
  CAL's one-directional query LSTM (``fwd_cell`` alone) map alike.

``flax_variables_to_state_dict`` takes the whole variables dict: its
``params`` as above, and the ``batch_stats`` collection of flax BatchNorm
(``mean`` -> ``running_mean``, ``var`` -> ``running_var``, plus a
``num_batches_tracked`` buffer of 0 for each, which torch's BatchNorm
state carries and flax does not).

The port names its submodules after the flax ones, so the result loads
with ``model.load_state_dict(sd, strict=True)``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


LSTM_GATES = ("i", "f", "g", "o")
GRU_GATES = ("r", "z", "n")


def _cell_tensors(cell: Mapping) -> Dict[str, np.ndarray]:
    """A flax LSTM / GRU cell's gate Dense params -> torch's ``*_l0``
    tensors (see the module docstring)."""
    gates = LSTM_GATES if "ii" in cell else GRU_GATES
    get = lambda name, leaf: np.array(cell[name][leaf], dtype=np.float32)
    w_ih = np.concatenate([get("i" + g, "kernel").T for g in gates])
    w_hh = np.concatenate([get("h" + g, "kernel").T for g in gates])
    h = w_hh.shape[1]
    if gates == LSTM_GATES:
        b_ih = np.zeros(4 * h, np.float32)
        b_hh = np.concatenate([get("h" + g, "bias") for g in gates])
    else:
        b_ih = np.concatenate([get("i" + g, "bias") for g in gates])
        b_hh = np.concatenate([np.zeros(2 * h, np.float32), get("hn", "bias")])
    return {"weight_ih_l0": w_ih, "weight_hh_l0": w_hh, "bias_ih_l0": b_ih,
            "bias_hh_l0": b_hh}


def _is_cell(tree: Mapping) -> bool:
    names = set(tree)
    return names in ({"i" + g for g in LSTM_GATES} | {"h" + g for g in LSTM_GATES},
                     {"i" + g for g in GRU_GATES} | {"h" + g for g in GRU_GATES})


def flax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params``: the flax ``variables["params"]`` tree, as nested mappings
    of array-likes (``jax.device_get`` of the tree; each leaf is copied
    into a float32 numpy array)."""
    out: Dict[str, torch.Tensor] = {}

    def visit(tree: Mapping, prefix: str) -> None:
        for name, value in tree.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(value, Mapping) and _is_cell(value):
                for key, a in _cell_tensors(value).items():
                    out[f"{path}.{key}"] = torch.from_numpy(np.ascontiguousarray(a))
                continue
            if isinstance(value, Mapping):
                visit(value, path)
                continue
            a = np.array(value, dtype=np.float32)         # a writable copy
            if name == "kernel":
                if a.ndim == 2:
                    a = a.T
                elif a.ndim in (3, 4, 5):
                    # (*spatial, in, out) -> (out, in, *spatial)
                    a = a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))
                else:
                    raise ValueError(f"{path}: unexpected kernel rank {a.ndim}")
                key = f"{prefix}.weight"
            elif name == "scale":
                key = f"{prefix}.weight"
            elif name in ("bias", "pos_embed", "clusters", "clusters2"):
                key = path
            else:
                raise ValueError(f"{path}: unknown flax leaf {name!r}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))

    visit(params, "")
    return out


BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def flax_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``variables``: the whole flax variables dict (``params`` and, for
    models with flax BatchNorm, ``batch_stats``)."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unknown flax collections {sorted(unknown)}")
    out = flax_params_to_state_dict(variables["params"])

    def visit(tree: Mapping, prefix: str) -> None:
        for name, value in tree.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(value, Mapping):
                visit(value, path)
                continue
            if name not in BATCH_STATS:
                raise ValueError(f"{path}: unknown batch_stats leaf {name!r}")
            out[f"{prefix}.{BATCH_STATS[name]}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    visit(variables.get("batch_stats", {}), "")
    return out


def flax_resnet152_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``ResNet152`` variables -> the port's
    ``features.backbones.ResNet152`` state_dict (torchvision's names):
    ``layer{S}_{B}`` -> ``layer{S}.{B}``, ``downsample_conv`` /
    ``downsample_bn`` -> ``downsample.0`` / ``downsample.1``."""
    out = {}
    for key, value in flax_variables_to_state_dict(variables).items():
        parts = key.split(".")
        if parts[0].startswith("layer"):
            stage, block = parts[0].split("_")
            parts[:1] = [stage, block]
        key = ".".join(parts).replace("downsample_conv", "downsample.0")
        out[key.replace("downsample_bn", "downsample.1")] = value
    return out


def flax_i3d_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``InceptionI3d`` variables -> the port's
    ``features.backbones.InceptionI3d`` state_dict (the same names; its
    scale-free BatchNorm keeps no ``num_batches_tracked``)."""
    return {k: v for k, v in flax_variables_to_state_dict(variables).items()
            if not k.endswith("num_batches_tracked")}


def flax_roberta_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A transformers Flax RoBERTa's ``params`` (``FlaxRobertaModel`` or
    ``FlaxRobertaForMaskedLM``) -> the torch model's state_dict: paths
    joined with ".", Dense ``kernel`` (in, out) -> ``weight`` (out, in),
    LayerNorm ``scale`` and Embed ``embedding`` -> ``weight``; the masked
    LM's decoder is tied to the word embeddings and its bias to
    ``lm_head.bias``, as torch's model ties them."""
    out: Dict[str, torch.Tensor] = {}

    def visit(tree: Mapping, prefix: str) -> None:
        for name, value in tree.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(value, Mapping):
                visit(value, path)
                continue
            a = np.array(value, dtype=np.float32)
            if name == "kernel":
                a = a.T
            if name in ("kernel", "scale", "embedding"):
                path = f"{prefix}.weight"
            elif name != "bias":
                raise ValueError(f"{path}: unknown flax leaf {name!r}")
            out[path] = torch.from_numpy(np.ascontiguousarray(a))

    visit(params, "")
    if "lm_head.bias" in out:
        out["lm_head.decoder.weight"] = out["roberta.embeddings.word_embeddings.weight"]
        out["lm_head.decoder.bias"] = out["lm_head.bias"]
    return out
