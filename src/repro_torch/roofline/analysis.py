"""Roofline analysis of one step on one card, counted on meta tensors (port
of ``repro.roofline.analysis``).

Three terms per (arch, shape):

  compute    = FLOPs / peak FLOP/s of the step's compute dtype, the
               kernels' own work at their units' rates
  memory     = bytes / HBM bandwidth
  collective = collective bytes / link bandwidth   (0 on one card)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of the
compiled SPMD program and the peak from ``memory_analysis()``.  The port
has no compiler between the step and the card, so :func:`analyze_step`
runs the step once on ``meta`` tensors (shapes only, nothing allocated)
and counts what the eager program does:

  * FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
    einsums, convolutions, attention; not elementwise ops, which XLA
    counts too);
  * bytes with :class:`StepCounter`, a ``TorchDispatchMode`` that sums the
    operand and result bytes of each aten op.  That is the traffic of the
    eager program, op by op; it is not XLA's count after fusion;
  * argument bytes, output bytes and a peak of live bytes, by following
    each storage from the op that makes it until Python frees it.

A kernel call (``kernels.ops``) on meta runs its plain version inside a
kernel region (``ops.META_OBSERVERS``).  ``hlo_flops`` counts the plain
version's FLOPs, as the reference's probes count ``impl="ref_unchunked"``
(a causal attention's full s x s).  The floor does not: it takes those
FLOPs out (``kernel_plain_flops``) and charges K6's, K7's and K8's own
operations instead (their modules' ``work``: the pairs a causal mask lets
through, the chunked scan) and the rest at the compute dtype's.  A
kernel's ``work`` also says how many of its products are bf16 ones: those
are charged at the bf16 tensor-core rate (one product each); and how many
have one bf16 operand beside a float32 one: a bf16 value is exact in
tf32, so those take two TF32 products each; the rest take three (3xTF32)
at the TF32 rate.  K6's and K7's are bf16 ones where their operands are
bf16; on bf16 operands K8's C B^T is a bf16 one and its other products
(a float32 intermediate times x, B or C) have one bf16 operand.  Its
bytes and memory are the kernel's operands, outputs and workspace
(written once, read once), so the plain version's s x s score matrix,
which the kernel never holds, is neither moved nor live.

``collective_bytes`` is the reference's parser of post-SPMD HLO text, kept
for parity; a one-card step has no collectives.
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.roofline.hw import H100, ChipSpec

# the name of the steps' compute dtype in ``ChipSpec.peak_flops``
DTYPE_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16"}

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
    "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVE_RE = re.compile(
    r"=\s*(?:\(?)((?:[a-z0-9]+\[[0-9,]*\][^ ]*(?:,\s*)?)+)\)?\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _tensor_bytes(type_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 2


_MULTIPLIER = {
    "all-gather": lambda g: (g - 1) / g,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


def collective_bytes(hlo_text: str) -> Tuple[float, Dict[str, float]]:
    """Returns (total per-device link bytes, per-op-kind breakdown) of HLO
    text: each collective's result bytes times its ring multiplier for the
    replica-group size g (fallback 2); an async ``-done`` is not counted
    again."""
    per_kind: Dict[str, float] = {}
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.search(line)
        if not m:
            continue
        if "-done(" in line:   # async pair: count the -start only
            continue
        type_str, kind = m.group(1), m.group(2)
        moved = _tensor_bytes(type_str) * _MULTIPLIER[kind](_group_size(line))
        per_kind[kind] = per_kind.get(kind, 0.0) + moved
    return sum(per_kind.values()), per_kind


@dataclass
class RooflineReport:
    """The reference's report on one card.  ``hlo_flops`` / ``hlo_bytes``
    keep the reference's names for the step's FLOPs and bytes (counted on
    meta tensors here, see the module docstring); ``kernel_plain_flops`` is
    the part of ``hlo_flops`` counted inside kernel regions, and
    ``kernel_products`` / ``kernel_other`` the kernels' own operations
    that the floor charges in its place, ``kernel_products_bf16`` the part
    of ``kernel_products`` charged at the bf16 rate and
    ``kernel_products_tf32x2`` the part with one bf16 operand, charged as
    two TF32 products each."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, float]
    model_flops: float
    bytes_per_device: float = 0.0
    peak_memory_per_device: float = 0.0
    arg_bytes: float = 0.0
    output_bytes: float = 0.0
    compute_dtype: str = "fp32"
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    kernel_plain_flops: float = 0.0
    kernel_products: float = 0.0
    kernel_other: float = 0.0
    kernel_products_bf16: float = 0.0
    kernel_products_tf32x2: float = 0.0

    chip: ChipSpec = H100

    @property
    def t_compute(self) -> float:
        """The FLOPs outside the kernels and the kernels' other operations
        at the compute dtype's peak, plus the kernels' products on the
        tensor cores: bf16 ones at the bf16 rate, those with one bf16
        operand as two TF32 products, the others in 3xTF32 (three TF32
        products for each fp32 one)."""
        rest = self.hlo_flops - self.kernel_plain_flops + self.kernel_other
        x2 = self.kernel_products_tf32x2
        x3 = self.kernel_products - self.kernel_products_bf16 - x2
        return (rest / self.chip.peak_flops(self.compute_dtype)
                + self.kernel_products_bf16 / self.chip.peak_flops_bf16
                + (2 * x2 + 3 * x3) / self.chip.peak_flops_tf32)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.chip.hbm_bandwidth

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.chip.ici_link_bandwidth

    @property
    def t_floor(self) -> float:
        """The least time of the step: its largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("chip")
        d.update(chip=self.chip.name, t_compute=self.t_compute,
                 t_memory=self.t_memory, t_collective=self.t_collective,
                 t_floor=self.t_floor, dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (forward-only), N = active
    params, D = tokens processed in the step."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch * 1          # decode: one token


# ---------------------------------------------------------------------------
# Counting a step on meta tensors
# ---------------------------------------------------------------------------
def tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    return []


def nbytes(t: torch.Tensor) -> int:
    """Bytes a tensor addresses: its elements, or its storage where that is
    smaller (a broadcast)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _unique_bytes(ts) -> int:
    seen, total = set(), 0
    for t in ts:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += nbytes(t)
    return total


_ATEN = torch.ops.aten
# allocation only: no traffic
_ALLOCATE = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
             _ATEN.empty_like.default, _ATEN.new_empty.default,
             _ATEN.new_empty_strided.default}
# write self in full from the other operands: they are read, self written
_OVERWRITE = {_ATEN.copy_.default, _ATEN.fill_.Scalar, _ATEN.fill_.Tensor,
              _ATEN.zero_.default}
# write a few rows of self: the other operands are read and as many bytes
# written
_SCATTER = {_ATEN.index_put_.default, _ATEN._index_put_impl_.default,
            _ATEN.index_copy_.default, _ATEN.scatter_.src,
            _ATEN.scatter_.value, _ATEN.scatter_add_.default,
            _ATEN.index_add_.default}


class StepCounter(TorchDispatchMode):
    """Bytes moved and live bytes of an eager step on meta tensors.

    Each aten op outside a kernel region moves its operands' and results'
    bytes (a view moves none; an allocation none; an overwrite of ``self``
    reads the other operands and writes ``self``; a scatter into ``self``
    reads the other operands and writes as many bytes).  Each storage an op
    makes is live until Python frees it.  Inside a kernel region
    (``kernels.ops._plain``) nothing is counted; at its end the kernel's
    operands and outputs are moved, its workspace written and read, and
    its outputs and workspace are live.  For a kernel that counts its own
    work, the FLOPs ``flops`` counted inside the region go to
    ``kernel_plain_flops`` and the kernel's own operations to
    ``kernel_products`` / ``kernel_other``, and those of its products that
    are bf16 ones to ``kernel_products_bf16`` too and those with one bf16
    operand to ``kernel_products_tf32x2`` (each kernel's ``work`` says
    which)."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.kernel_calls: Dict[str, int] = {}
        self.kernel_plain_flops = 0
        self.kernel_products = 0
        self.kernel_other = 0
        self.kernel_products_bf16 = 0
        self.kernel_products_tf32x2 = 0
        self._flops = flops
        self._flops_at = 0
        self._depth = 0
        self._tracked: Dict[int, Any] = {}

    def track(self, t: torch.Tensor, size: int = None) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        size = st.nbytes() if size is None else size

        def freed(_, key=key, size=size):
            if self._tracked.pop(key, None) is not None:
                self.live -= size
        self._tracked[key] = weakref.ref(st, freed)
        self.live += size
        self.peak = max(self.peak, self.live)

    def __enter__(self):
        ops.META_OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.META_OBSERVERS.remove(self)
        return super().__exit__(*exc)

    def kernel_enter(self, name: str) -> None:
        if not self._depth:
            self._flops_at = self._flops.get_total_flops()
        self._depth += 1

    def kernel_exit(self, name: str, operands, outputs,
                    workspace_bytes: int, work) -> None:
        self._depth -= 1
        if self._depth:
            return
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        if work is not None:
            self.kernel_plain_flops += (self._flops.get_total_flops()
                                        - self._flops_at)
            self.kernel_products += work[0]
            self.kernel_other += work[1]
            self.kernel_products_bf16 += work[2]
            self.kernel_products_tf32x2 += work[3]
        outs = tensors(outputs)
        out_bytes = sum(nbytes(t) for t in outs)
        self.bytes += (_unique_bytes(operands) + out_bytes
                       + 2 * workspace_bytes)
        self.peak = max(self.peak, self.live + out_bytes + workspace_bytes)
        for t in outs:
            self.track(t, nbytes(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._depth or func.is_view:
            return out
        results = tensors(out)
        if func not in _ALLOCATE:
            operands = tensors(args) + tensors(kwargs or {})
            if func in _OVERWRITE or func in _SCATTER:
                rest = [t for t in operands[1:]
                        if t.untyped_storage() is not
                        operands[0].untyped_storage()]
                moved = _unique_bytes(rest)
                self.bytes += moved + (nbytes(operands[0])
                                       if func in _OVERWRITE else moved)
            else:
                self.bytes += (_unique_bytes(operands)
                               + sum(nbytes(t) for t in results))
        for t in results:
            self.track(t)
        return out


def analyze_step(fn, abstract_args, *, arch: str, shape,
                 cfg) -> RooflineReport:
    """Run ``fn(*abstract_args)`` on meta tensors and count its FLOPs,
    bytes, argument, output and peak live bytes (module docstring), for
    one H100 computing in ``launch.specs.COMPUTE_DTYPE`` (as it stands at
    this call).  The arguments
    are live from the start; ``output_bytes`` counts the outputs that are
    not an argument updated in place (a decode step's cache)."""
    arg_tensors = tensors(abstract_args)
    if not all(t.is_meta for t in arg_tensors):
        raise ValueError("analyze_step: the abstract arguments must be "
                         "meta tensors")
    flops = FlopCounterMode(display=False)
    counter = StepCounter(flops)
    with flops, counter:
        for t in arg_tensors:
            counter.track(t)
        out = fn(*abstract_args)
    arg_storages = {id(t.untyped_storage()) for t in arg_tensors}
    new_outputs = [t for t in tensors(out)
                   if id(t.untyped_storage()) not in arg_storages]
    return RooflineReport(
        arch=arch, shape=shape.name, mesh="1x1", chips=1,
        hlo_flops=float(flops.get_total_flops()),
        hlo_bytes=float(counter.bytes), coll_bytes=0.0, coll_breakdown={},
        model_flops=model_flops(cfg, shape),
        bytes_per_device=float(counter.bytes),
        peak_memory_per_device=float(counter.peak),
        arg_bytes=float(_unique_bytes(arg_tensors)),
        output_bytes=float(_unique_bytes(new_outputs)),
        compute_dtype=DTYPE_NAME[specs.COMPUTE_DTYPE],
        kernel_calls=dict(counter.kernel_calls),
        kernel_plain_flops=float(counter.kernel_plain_flops),
        kernel_products=float(counter.kernel_products),
        kernel_other=float(counter.kernel_other),
        kernel_products_bf16=float(counter.kernel_products_bf16),
        kernel_products_tf32x2=float(counter.kernel_products_tf32x2))
