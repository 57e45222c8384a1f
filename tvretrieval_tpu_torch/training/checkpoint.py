"""Checkpointing: model weights + optimizer state + model config + epoch.

Port of tvretrieval_tpu/training/checkpoint.py with ``torch.save`` in
place of orbax; the directory layout is the same (``<ckpt_dir>/state``,
``<ckpt_dir>/meta.json`` with ``model_cfg`` and ``epoch``). The reference
saves {"model": state_dict, "model_cfg", "epoch"} on metric improvement,
with no optimizer state (train.py:219-223); the optimizer state is kept
here too, so a run can resume.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch

from tvretrieval_tpu_torch.utils.io import load_json, save_json


def save_checkpoint(ckpt_dir: str, model_state: Dict[str, torch.Tensor],
                    opt_state: Optional[dict], model_cfg, epoch: int) -> None:
    """model_state: ``model.state_dict()``; opt_state:
    ``optimizer.state_dict()`` or None."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "state")
    torch.save({"params": model_state, "opt_state": opt_state}, path + ".tmp")
    os.replace(path + ".tmp", path)     # a killed run leaves the old state whole
    cfg_dict = (dataclasses.asdict(model_cfg) if dataclasses.is_dataclass(model_cfg)
                else dict(model_cfg))
    save_json({"model_cfg": cfg_dict, "epoch": epoch},
              os.path.join(ckpt_dir, "meta.json"), pretty=True)


def load_checkpoint(ckpt_dir: str, map_location="cpu") -> Tuple[Any, Any, dict, int]:
    """Returns (model state_dict, optimizer state_dict or None,
    model_cfg dict, epoch). Tensors only are unpickled (``weights_only``)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    state = torch.load(os.path.join(ckpt_dir, "state"), map_location=map_location,
                       weights_only=True)
    meta = load_json(os.path.join(ckpt_dir, "meta.json"))
    return state["params"], state.get("opt_state"), meta["model_cfg"], meta["epoch"]
