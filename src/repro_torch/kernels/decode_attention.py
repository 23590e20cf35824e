"""K7: decode attention (one new token against the KV cache) as a
hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.decode_attention.decode_attention``
(source: ``csrc/decode_attention.cu``): each batch row's query attends to
the first ``cache_len[b]`` slots of its cache (a scalar is broadcast to
every row), with an optional window and logit softcap, GQA, on float32 or
bfloat16 operands (q and the caches of one dtype, the output in it too;
the sums and the workspace float32).  One block per (kv-head group, row,
split of the row's valid slots) writes a partial softmax state to a
workspace, and the splits are merged in a fixed order (bit-identical run to
run).  bfloat16 caches whose head dim is a multiple of 8 up to 256,
16-byte aligned (:func:`on_tma`), take the split kernel that loads K and V
tiles of 4 kv-heads by TMA and runs q.k and p.v on the tensor cores.
float32 caches past d = 128 with d a multiple of 4, 16-byte aligned
(:func:`on_bulk`: gemma2's float32 serving decode), take a kernel that
copies contiguous tiles of 4 kv-heads by ``cp.async.bulk`` and merges the
splits in each row's last block, one launch a call.  Both size their
splits by the card's resident blocks, the TMA kernel's in whole waves,
the bulk kernel's in one (:func:`plan`, which also sizes the workspace,
:func:`workspace_bytes`).  Other operands
take the split kernel of the first design and a combine kernel, two
launches a call (bf16 widened as it loads).  The plain PyTorch version is
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
# (the float32 bulk kernel's too: 192 KB a block, one an SM)
H100_RESIDENT = H100.sms * TMA_BLOCKS_PER_SM
BULK_TILE = 8         # slots a tile of the float32 bulk kernel
BULK_HEADS = 4        # q-heads a warp of the float32 bulk kernel carries
                      # past a GQA group of 2
BULK_MAX_ROWS = 1 << 16   # (batch row, block column) pairs its arrival
                          # counts hold


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
    Without (the split kernel of float32 operands), into splits of at
    least ``SPLIT_SLOTS`` slots, as many as bring the grid to about
    ``TARGET_BLOCKS`` blocks (the bulk kernel's: :func:`bulk_splits`)."""
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


@functools.lru_cache(maxsize=None)
def bulk_splits(b: int, S: int, n_kv: int, window: Optional[int],
                resident: int, nsub: int = 1) -> Tuple[int, int]:
    """(slots per split, number of splits) of the float32 bulk kernel: the
    longest valid length the host knows (``S``, or a shorter window) cut
    into whole ``BULK_TILE``-slot tiles, into as many splits as one wave of
    ``resident`` blocks holds beside the others of the call (``b`` x groups
    of 4 kv-heads x ``nsub`` group parts): a block's merge waits for its
    row's last split, so a second wave would hold every row back."""
    longest = min(S, window) if window else S
    tiles = -(-longest // BULK_TILE)
    pairs = max(1, b * -(-n_kv // TMA_KV_HEADS) * nsub)
    n = max(1, min(tiles, resident // pairs))
    per = -(-tiles // n) * BULK_TILE
    return per, -(-longest // per)


def on_tma(q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor) -> bool:
    """Whether the launcher runs these operands on the bf16 TMA kernel:
    bfloat16, a head dim that is a multiple of 8 up to ``TMA_MAX_DIM``,
    the caches 16-byte aligned (the launcher's own test)."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] <= TMA_MAX_DIM
            and tma_ready(k_cache, v_cache))


def on_bulk(q: torch.Tensor, k_cache: torch.Tensor,
            v_cache: torch.Tensor) -> bool:
    """Whether the launcher runs these operands on the float32 bulk kernel
    (contiguous tiles of 4 kv-heads by ``cp.async.bulk``, the combine in
    each row's last block): float32, 128 < d <= ``TMA_MAX_DIM``, d a
    multiple of 4, the caches 16-byte aligned (the launcher's own
    test)."""
    d = q.shape[-1]
    return (q.dtype == torch.float32 and 128 < d <= TMA_MAX_DIM
            and d % 4 == 0 and k_cache.data_ptr() % 16 == 0
            and v_cache.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=None)
def resident_blocks(d: int, device: int = -1,
                    dtype: torch.dtype = torch.bfloat16) -> int:
    """The card's SMs times the blocks of the kernel that ``dtype``
    operands of head dim ``d`` run on (the bf16 TMA kernel, the float32
    bulk kernel) that one SM holds at once, as the built library answers it
    for the current device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    asked once a (head dim, ``device``, dtype); raises where the library
    takes no such kernel for ``d`` or the query failed."""
    n = _build.query(_build.launcher("vpaas_decode_attention", dtype)
                     + "_resident", d)
    if n <= 0:
        raise RuntimeError(f"decode_attention: no resident blocks of the "
                           f"{dtype} kernel at head dim {d}")
    return n


SPLIT_GRID = ("heads_a_block", "blocks", "one_head_blocks")


def split_grid() -> dict:
    """The split kernel's last launch as its launcher set it up, read from
    the built library: its q-heads a block, the blocks of its grid, and
    those of them that carry one q-head (a group past the block's heads
    is cut into parts, the last of the rest).  All 0 before any launch of
    the split kernel; the TMA and bulk kernels leave it as it was."""
    return {name: _build.query("vpaas_decode_attention_split_grid", i)
            for i, name in enumerate(SPLIT_GRID)}


def plan(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         window: Optional[int], resident: Optional[int] = None
         ) -> Tuple[int, int]:
    """(slots per split, number of splits) the launcher runs these operands
    with: on the bf16 TMA kernel (:func:`on_tma`) in whole waves of
    ``resident`` blocks (:func:`splits`), on the float32 bulk kernel
    (:func:`on_bulk`) in one (:func:`bulk_splits`), the card's resident
    blocks (:func:`resident_blocks`) where None; else the split kernel's
    (:func:`splits`)."""
    b, n_q, d = q.shape
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    group = n_q // n_kv
    tma, bulk = on_tma(q, k_cache, v_cache), on_bulk(q, k_cache, v_cache)
    if not (tma or bulk):
        return splits(b, S, n_kv, window)
    if resident is None:
        resident = resident_blocks(d, q.get_device(), q.dtype)
    if tma:
        return splits(b, S, n_kv, window, resident, -(-group // TMA_HEADS))
    return bulk_splits(b, S, n_kv, window, resident,
                       1 if group <= 2 else -(-group // BULK_HEADS))


def workspace_bytes(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, window: Optional[int],
                    resident: Optional[int] = None) -> int:
    """Bytes of the per-call workspace: each split's partial softmax state
    (d + 2 floats, whatever the operands' dtype; d + 4 on the bulk kernel,
    whose merge copies 16-byte rows) for every (row, query head), at
    :func:`plan`'s splits (the dry run passes ``H100_RESIDENT``)."""
    b, n_q, d = q.shape
    _, nsplit = plan(q, k_cache, v_cache, window, resident)
    row = d + (4 if on_bulk(q, k_cache, v_cache) else 2)
    return 4 * b * n_q * nsplit * row


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
    if (on_bulk(q, k_cache, v_cache) and b * -(-n_kv // TMA_KV_HEADS)
            * -(-(n_q // n_kv) // BULK_HEADS) > BULK_MAX_ROWS):
        raise ValueError(f"decode_attention: {b} rows x {n_kv} kv-heads "
                         f"pass the float32 kernel's {BULK_MAX_ROWS} "
                         "arrival counts")
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
