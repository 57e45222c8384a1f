"""Flax parameter tree -> PyTorch ``state_dict`` for the port's modules.

The inverse of the torch->flax map the JAX package's tests use to load the
reference model (tests/test_xml.py:334-398): module paths join with ".",
and leaves map by name:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
- Conv ``kernel`` (k, in, out) -> ``weight`` (out, in, k);
- LayerNorm ``scale`` -> ``weight``; ``bias`` and ``pos_embed`` unchanged.

The port names its submodules after the flax ones, so the result loads
with ``model.load_state_dict(sd, strict=True)``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params``: the flax ``variables["params"]`` tree, as nested mappings
    of array-likes (``jax.device_get`` of the tree; each leaf is copied
    into a float32 numpy array)."""
    out: Dict[str, torch.Tensor] = {}

    def visit(tree: Mapping, prefix: str) -> None:
        for name, value in tree.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(value, Mapping):
                visit(value, path)
                continue
            a = np.array(value, dtype=np.float32)         # a writable copy
            if name == "kernel":
                if a.ndim == 2:
                    a = a.T
                elif a.ndim == 3:
                    a = a.transpose(2, 1, 0)
                else:
                    raise ValueError(f"{path}: unexpected kernel rank {a.ndim}")
                key = f"{prefix}.weight"
            elif name == "scale":
                key = f"{prefix}.weight"
            elif name in ("bias", "pos_embed"):
                key = path
            else:
                raise ValueError(f"{path}: unknown flax leaf {name!r}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))

    visit(params, "")
    return out
