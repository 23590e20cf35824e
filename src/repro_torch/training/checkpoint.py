"""Checkpointing: flat ``.npz`` save/restore for nested trees, port of
``repro.training.checkpoint``.

The format is the JAX package's (keys encode the tree path, conv weights
HWIO; :mod:`repro_torch.weights` writes it), so a checkpoint moves between
the two packages in both directions, optimizer state included.  ``restore``
rebuilds against a reference tree, which fixes the structure, the dtypes
and the device.  Convs are told apart by rank, as everywhere in
:mod:`repro_torch.weights`: the video models' and their optimizer state's
trees only.  The LLM stack's 4-d leaves are not convs: save and restore an
LLM tree with ``hwio=False``.
"""
from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.weights import _hwio_to_oihw, map_with_path
from repro_torch.weights import save_npz as save

__all__ = ["save", "restore", "load_metadata"]


def restore(path: str, like, hwio: bool = True) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, whose
    shapes, dtypes and devices the restored leaves take); ``hwio=False``
    for an LLM tree.  A bf16 leaf saved as float32 (``save`` of a bf16
    tree) goes back into a bf16 ``like`` exactly, as does a bf16 leaf the
    JAX package saved.  Raises ``ValueError`` when a leaf's shape
    differs."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        def leaf(key, ref):
            arr = np.array(data[key])
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                # a bf16 leaf as the JAX package writes it (ml_dtypes'
                # bfloat16 comes back from .npz as 2-byte voids)
                arr = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            else:
                arr = torch.from_numpy(arr)
            if hwio:
                arr = _hwio_to_oihw(arr)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint shape mismatch at {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(ref.shape)}")
            return arr.to(dtype=ref.dtype, device=ref.device)
        return map_with_path(leaf, like)


def load_metadata(path: str) -> Dict[str, Any]:
    with open(path + ".meta.json") as f:
        return json.load(f)
