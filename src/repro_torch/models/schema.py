"""Parameter schema: one declaration drives init, sharding specs and shapes
(port of ``repro.models.schema``).

Every layer module exposes ``schema(cfg) -> tree of Leaf``.  A ``Leaf``
declares the parameter's shape, *logical* axis names (one per dim) and its
initializer.  From a schema we derive:

  * ``init(schema, gen, device)``      -> parameter tree (real tensors)
  * ``abstract(schema, dtype)``        -> meta-tensor tree (dry run)
  * ``partition_specs(schema, rules)`` -> PartitionSpec tree

Trees are nested dicts with the JAX package's keys, so a parameter tree of
either package maps onto the other leaf for leaf.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.sharding import PartitionSpec


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | fan_in | small_a
    scale: float = 1.0


def _init_leaf(leaf: Leaf, gen: torch.Generator, device,
               dtype) -> torch.Tensor:
    if len(leaf.shape) != len(leaf.axes):
        raise ValueError(f"leaf rank mismatch: {leaf}")
    kw = dict(device=device, dtype=torch.float32)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, **kw).to(dtype)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, **kw).to(dtype)
    if leaf.init == "normal":
        return torch.randn(leaf.shape, generator=gen, **kw).mul_(
            0.02 * leaf.scale).to(dtype)
    if leaf.init == "fan_in":
        fan_in = leaf.shape[-2] if len(leaf.shape) > 1 else 1
        return torch.randn(leaf.shape, generator=gen, **kw).mul_(
            leaf.scale / math.sqrt(max(fan_in, 1))).to(dtype)
    if leaf.init == "small_a":   # mamba A_log init: log(uniform[1,16])
        u = torch.rand(leaf.shape, generator=gen, **kw)
        return u.mul_(15.0).add_(1.0).log_().to(dtype)
    raise ValueError(f"unknown init {leaf.init!r}")


def init(schema, gen: torch.Generator, device="cuda",
         dtype=torch.float32):
    """Parameter tree for ``schema``: leaves drawn in the tree's key order
    from ``gen`` (which must live on ``device``).  Empty sub-trees (the
    shared-attention slot of a block unit) stay empty dicts."""
    if isinstance(schema, Leaf):
        return _init_leaf(schema, gen, device, dtype)
    return {k: init(v, gen, device, dtype) for k, v in schema.items()}


def is_leaf(x: Any) -> bool:
    return isinstance(x, Leaf)


def map_with_key(fn: Callable, schema):
    """Apply fn(leaf) over a schema tree (empty sub-trees stay empty)."""
    if is_leaf(schema):
        return fn(schema)
    return {k: map_with_key(fn, v) for k, v in schema.items()}


def abstract(schema, dtype=torch.float32, prepend: Tuple[int, ...] = ()):
    """Meta-tensor tree of the schema's shapes (optionally with a stacked
    leading dim): shapes and a dtype, nothing allocated."""
    return map_with_key(
        lambda l: torch.empty(prepend + l.shape, dtype=dtype, device="meta"),
        schema)


def partition_specs(schema, rules: Dict[str, Any]):
    """Each leaf's logical axes through ``rules`` (``models.sharding``)."""
    return map_with_key(
        lambda l: PartitionSpec(*(rules.get(ax) if ax is not None else None
                                  for ax in l.axes)), schema)


def stack(schema, n: int):
    """Schema with a stacked leading (block) dimension."""
    if isinstance(schema, Leaf):
        return Leaf((n,) + schema.shape, ("layers",) + schema.axes,
                    schema.init, schema.scale)
    return {k: stack(v, n) for k, v in schema.items()}


def leaves(schema):
    if isinstance(schema, Leaf):
        yield schema
        return
    for v in schema.values():
        yield from leaves(v)


def param_bytes(schema, bytes_per_param: int = 4) -> int:
    return sum(math.prod(l.shape) for l in leaves(schema)) * bytes_per_param


def tree_map(fn, tree: Dict[str, Any]):
    """``fn`` over the tensor leaves of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
