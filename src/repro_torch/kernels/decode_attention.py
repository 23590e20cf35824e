"""K7: decode attention (one new token against the KV cache) as a
hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.decode_attention.decode_attention``
(source: ``csrc/decode_attention.cu``): each batch row's query attends to
the first ``cache_len[b]`` slots of its cache (a scalar is broadcast to
every row), with an optional window and logit softcap, GQA, on float32 or
bfloat16 operands (q and the caches of one dtype, the output in it too;
the sums and the workspace float32).  A call runs two device kernels: one
block per (kv-head group, row, split of the row's valid slots) writes a
partial softmax state to a workspace, and a combine kernel merges the
splits in a fixed order.  bfloat16 caches whose head dim is a multiple of
8 up to 256, 16-byte aligned (:func:`on_tma`), take the split kernel that
loads K and V tiles by TMA and runs q.k and p.v on the tensor cores; its
splits fill the card's resident blocks in whole waves (:func:`plan`, which
also sizes the workspace, :func:`workspace_bytes`).  Other operands take the
float32 design (bf16 widened as it loads).  The plain PyTorch version is
:func:`decode_attention_ref` (``ref.decode_attention``); the kernel agrees
with it within ``testing.ATTN_ATOL`` (float32) or ``testing.ATTN_BF16_RTOL``
(bfloat16).  float16 raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, check_options,
                                                 pair_work, row_array,
                                                 tma_ready)
from repro_torch.roofline.hw import H100

launches = 0          # wrapper calls that launched the kernels (ops.py)
launches_bf16 = 0     # the launches among them on bf16 operands

decode_attention_ref = ref.decode_attention

SPLIT_SLOTS = 64      # fewest slots a split takes: two 32-slot tiles
TARGET_BLOCKS = 1024  # blocks a call aims at: ~8 per SM of an H100's 132
TMA_TILE = 16         # slots a tile of the bf16 TMA kernel
TMA_KV_HEADS = 4      # kv-heads a block of it (one a warp)
TMA_HEADS = 16        # q-heads of a kv-head a block takes (the mma's rows)
TMA_MAX_DIM = 256     # the largest head dim it takes
WAVE_FILL = 0.9       # the share of the last wave's blocks its splits want
TMA_BLOCKS_PER_SM = 1  # a block asks for 120 KB of shared memory (224 at
                       # d > 128)
# the TMA kernel's resident blocks on an H100, which the dry run plans by
H100_RESIDENT = H100.sms * TMA_BLOCKS_PER_SM


@functools.lru_cache(maxsize=None)
def splits(b: int, S: int, n_kv: int, window: Optional[int],
           resident: Optional[int] = None, nsub: int = 1
           ) -> Tuple[int, int]:
    """(slots per split, number of splits) for a call.  The longest valid
    length the host knows without reading ``cache_len`` from the device is
    ``S``, or the window where it is shorter.  With ``resident`` (the
    card's SMs times the bf16 TMA kernel's resident blocks an SM) it is cut
    into whole 16-slot tiles, as few splits as bring the blocks of each
    split index (``b`` x groups of 4 kv-heads x ``nsub`` groups of 16
    q-heads) to whole waves of ``resident`` blocks, the last at least
    ``WAVE_FILL`` full (else the fullest).
    Without (the float32 kernel), into splits of at least ``SPLIT_SLOTS``
    slots, as many as bring the grid to about ``TARGET_BLOCKS`` blocks."""
    longest = min(S, window) if window else S
    if resident is None:
        want = -(-TARGET_BLOCKS // max(1, b * n_kv))
        per = max(SPLIT_SLOTS, -(-longest // want))
        per = -(-per // 32) * 32               # whole 32-slot tiles
        return per, -(-longest // per)
    tiles = -(-longest // TMA_TILE)
    pairs = max(1, b * -(-n_kv // TMA_KV_HEADS) * nsub)
    best, best_fill = 1, 0.0
    for n in range(1, tiles + 1):
        blocks = pairs * n
        fill = blocks / (-(-blocks // resident) * resident)
        if fill > best_fill:
            best, best_fill = n, fill
        if fill >= WAVE_FILL:
            break
    per = -(-tiles // best) * TMA_TILE
    return per, -(-longest // per)


def on_tma(q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor) -> bool:
    """Whether the launcher runs these operands on the bf16 TMA kernel:
    bfloat16, a head dim that is a multiple of 8 up to ``TMA_MAX_DIM``,
    the caches 16-byte aligned (the launcher's own test)."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] <= TMA_MAX_DIM
            and tma_ready(k_cache, v_cache))


@functools.lru_cache(maxsize=None)
def resident_blocks(d: int, device: int = -1) -> int:
    """The card's SMs times the blocks of the bf16 TMA kernel for head dim
    ``d`` that one SM holds at once, as the built library answers it for
    the current device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    asked once a (head dim, ``device``); raises where the library takes no
    such kernel for ``d`` or the query failed."""
    n = _build.query("vpaas_decode_attention_bf16_resident", d)
    if n <= 0:
        raise RuntimeError(f"decode_attention: no resident blocks of the "
                           f"bf16 TMA kernel at head dim {d}")
    return n


def plan(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         window: Optional[int], resident: Optional[int] = None
         ) -> Tuple[int, int]:
    """(slots per split, number of splits) the launcher runs these operands
    with (:func:`splits`): on the bf16 TMA kernel (:func:`on_tma`) in whole
    waves of ``resident`` blocks, the card's (:func:`resident_blocks`)
    where None; else the float32 design's."""
    b, n_q, d = q.shape
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    if not on_tma(q, k_cache, v_cache):
        return splits(b, S, n_kv, window)
    if resident is None:
        resident = resident_blocks(d, q.get_device())
    return splits(b, S, n_kv, window, resident,
                  -(-(n_q // n_kv) // TMA_HEADS))


def workspace_bytes(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, window: Optional[int],
                    resident: Optional[int] = None) -> int:
    """Bytes of the per-call workspace: each split's partial softmax state
    (d + 2 floats, whatever the operands' dtype) for every (row, query
    head), at :func:`plan`'s splits (the dry run passes
    ``H100_RESIDENT``)."""
    b, n_q, d = q.shape
    _, nsplit = plan(q, k_cache, v_cache, window, resident)
    return 4 * b * n_q * nsplit * (d + 2)


def work(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         cache_len, *, window: Optional[int] = None,
         softcap: Optional[float] = None) -> Tuple[int, int, int, int]:
    """(products, other, bf16 products, products with one bf16 operand:
    :func:`~repro_torch.kernels.flash_attention.pair_work`) operations K7
    does on these operands: each valid slot (the last ``window`` of them
    where there is one) for every row and query head.  A tensor
    ``cache_len`` (which has no value on meta) counts the whole cache (the
    roofline's floor; ``roofline.analysis``)."""
    b, n_q, d = q.shape
    S = k_cache.shape[1]
    rows = S if isinstance(cache_len, torch.Tensor) else min(int(cache_len),
                                                             S)
    if window:
        rows = min(rows, window)
    return pair_work(b * n_q * rows, d, v_cache.shape[-1], softcap,
                     q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q (b, n_q, d), caches (b, S, n_kv, d), all float32 or all bfloat16,
    cache_len scalar or (b,) -> (b, n_q, d) in their dtype."""
    global launches, launches_bf16
    b, n_q, d = q.shape
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    _build.check_operands(
        ("q", q, _build.DTYPES, None),
        ("k_cache", k_cache, _build.DTYPES, (b, S, n_kv, d)),
        ("v_cache", v_cache, _build.DTYPES, (b, S, n_kv, d)),
        same=[("q", "k_cache", "v_cache")])
    if n_kv == 0 or n_q % n_kv or not 0 < d <= MAX_HEAD_DIM or S == 0:
        raise ValueError(f"decode_attention: unsupported heads {n_q}/{n_kv},"
                         f" head dim {d} or {S} cache slots")
    check_options(window, softcap)
    clen = row_array(cache_len, b, q.device, "cache_len")
    out = torch.empty_like(q)
    if b and n_q:
        per, nsplit = plan(q, k_cache, v_cache, window)
        ws = torch.empty(workspace_bytes(q, k_cache, v_cache, window) // 4,
                         dtype=torch.float32, device=q.device)
        _build.launch(_build.launcher("vpaas_decode_attention", q.dtype),
                      q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                      clen.data_ptr(), ws.data_ptr(), out.data_ptr(), b, S,
                      n_q, n_kv, d, per, nsplit, window or 0,
                      float(softcap or 0.0), d ** -0.5)
        launches += 1
        launches_bf16 += q.dtype == torch.bfloat16
    return out
