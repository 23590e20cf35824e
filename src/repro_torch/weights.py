"""Model parameters for the port: random init, conversion from the JAX
package's parameters, and a flat ``.npz`` save/restore.

The port's parameters are nested dicts of tensors with the JAX package's
keys (``conv0/w``, ``head/b``, ``proj``, ``W``).  The one layout difference:
conv weights are OIHW here (``F.conv2d``), HWIO in the JAX package.  Every
4-d leaf is a conv weight, so conversion is by rank.

Sources of weights:

* :func:`init_detector` / :func:`init_classifier` — seeded random init from
  a ``torch.Generator``, following ``repro.models.schema`` (zeros for
  biases; ``normal / sqrt(fan_in)`` for the rest, with fan_in the
  second-to-last HWIO axis, i.e. ``cin`` for a conv — not ``9 * cin``);
* :func:`from_numpy_tree` — the JAX package's in-memory parameter pytree
  (nested dicts of numpy or JAX arrays, copied through numpy, so this
  module never imports JAX);
* :func:`load_npz` — the flat ``.npz`` that ``repro.training.checkpoint``
  writes (keys like ``conv0/w``, HWIO);
* :func:`save_npz` writes the same flat format back (HWIO), so checkpoints
  move between the two packages in both directions;
  :mod:`repro_torch.training.checkpoint` restores any such tree (optimizer
  state too) into the structure of a given one.

The LLM stack's parameters (``repro_torch.models.transformer``) are a
separate case: :func:`llm_from_numpy_tree` copies the JAX ``init_params``
pytree leaf for leaf, with no transposes -- stacked block leaves are 4-d
without being convs, and matmul weights keep the ``(in, out)`` layout.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro_torch.models import classifier as clf_mod
from repro_torch.models import detector as det_mod


def _hwio_to_oihw(a: torch.Tensor) -> torch.Tensor:
    return a.permute(3, 2, 0, 1).contiguous() if a.dim() == 4 else a


def _oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a


def _init_tree(shapes, gen: torch.Generator, device) -> Dict[str, Any]:
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = _init_tree(val, gen, device)
        elif key == "b":
            out[key] = torch.zeros(val, device=device)
        else:
            fan_in = val[-2] if len(val) > 1 else 1
            w = torch.randn(val, generator=gen) / math.sqrt(max(fan_in, 1))
            out[key] = _hwio_to_oihw(w).to(device)
    return out


def init_detector(cfg: DetectorConfig, gen: torch.Generator,
                  device="cuda") -> Dict[str, Any]:
    return _init_tree(det_mod.param_shapes(cfg), gen, device)


def init_classifier(cfg: ClassifierConfig, gen: torch.Generator,
                    device="cuda") -> Dict[str, Any]:
    return _init_tree(clf_mod.param_shapes(cfg), gen, device)


def from_numpy_tree(tree, device="cuda") -> Dict[str, Any]:
    """JAX-package parameter pytree (nested dicts of arrays) -> port params."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, dtype=np.float32, copy=True))
    return _hwio_to_oihw(t).to(device)


def llm_from_numpy_tree(tree, device="cuda",
                        dtype=torch.float32) -> Dict[str, Any]:
    """JAX-package LLM parameter (or cache) pytree -> the port's tree, every
    leaf a ``dtype`` tensor of the same shape; empty sub-trees stay empty
    dicts.  A leaf goes through float32 (numpy has no bfloat16 of its
    own): an ``ml_dtypes`` bf16 array widens exactly and ``dtype=
    torch.bfloat16`` narrows it back exactly, so the reference's bf16
    parameters arrive bit for bit."""
    if isinstance(tree, dict):
        return {k: llm_from_numpy_tree(v, device, dtype)
                for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32,
                                     copy=True)).to(device=device,
                                                    dtype=dtype)


def map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """Rebuild a nested tree with ``fn(key, leaf)`` at each leaf, ``key``
    being the JAX checkpoint's flat key: dict keys, ``.field`` for a
    NamedTuple's field, the index for a tuple or list, joined by ``/``
    (``conv0/w``, ``.mu/head/b``).  ``None`` is an empty subtree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (f".{k}",))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 (which numpy lacks) as float32,
    exactly: ``checkpoint.restore`` in either package narrows it back into
    a bf16 tree bit for bit."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flatten(tree, hwio: bool = True) -> Dict[str, np.ndarray]:
    """Flat ``{key: array}`` of a tree, convs back to HWIO (``hwio``; an LLM
    tree's 4-d leaves are not convs: pass False)."""
    flat = {}

    def put(key, leaf):
        arr = (_numpy(leaf) if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        flat[key] = _oihw_to_hwio(arr) if hwio else arr

    map_with_path(put, tree)
    return flat


def save_npz(path: str, params, metadata: Optional[Dict[str, Any]] = None,
             hwio: bool = True) -> None:
    """Flat ``.npz`` in the JAX checkpoint's format (HWIO convs) of a
    nested tree (params, optimizer state); a bare leaf is saved under
    ``params``.  ``hwio=False`` for an LLM tree (no convs)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tree = (params if isinstance(params, (dict, tuple, list))
            else {"params": params})
    np.savez(path, **_flatten(tree, hwio))
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def load_npz(path: str, device="cuda") -> Dict[str, Any]:
    """Restore a flat ``.npz`` (``conv0/w`` keys, HWIO) as port params."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return from_numpy_tree(tree, device)
