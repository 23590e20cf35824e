#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at its path's shapes,
and times kernel, plain version and a library yardstick with CUDA events.
It then drives its paths with the kernels' launch counts zeroed just
before and read just after each: the full-width video path
(``MultiStreamCoordinator`` with the ``vpaas_video`` models) on both hot
paths; the paper's comparison baselines (MPEG, Glimpse, CloudSeg, DDS)
beside VPaaS through ``default_policies()`` on the same models; the
continual-learning path on the same models (the per-site
``ContinualLearningPlane`` of ``serve --per-site-learning
--ensemble-serving``, whose background trainer runs every proximal step
through the update kernel, then the inline ``IncrementalLearner``); and
the LLM paths (``LLMServer`` over full-width ``zamba2-7b`` and over
full-width ``deepseek-v2-lite-16b``, MoE + MLA; ``transformer.prefill`` /
``decode_step`` over full-width ``musicgen-medium`` with stub conditioning
embeddings, cross-attention).  Weights are random from a seed.  Each
path's outputs are checked against the port's CPU path (the kernels'
plain versions) on a small input: one video chunk, the four baselines on
2 chunks x 4 frames of each content type, a 2-stream learning run,
``zamba2-7b`` cut to 9 layers, ``deepseek-v2-lite`` cut to its dense layer
and two MoE blocks, and ``musicgen-medium`` cut to 4 layers (with MoE,
rows at a router near-tie are exempt and counted).  Then it trains the
three video models at full width (``repro_torch.training``; no CUDA
kernel of the port runs there), holds three training steps on the card
against the CPU and against a second card run, and drives the video path,
the five policies and the learning plane once more on the trained
weights.  On the trained weights it then drives the sharded, claim-check
and multi-tenant serving planes: K = 4 ``ShardedScheduler`` shards against
one ``GraphScheduler`` (bitwise, under the oracle's conditions),
``MultiStreamCoordinator(num_shards=, use_store=True)`` at 64 streams with
K = 1 and 4, work stealing under a replica outage, and three tenants
(vision, the LLM-cascade pipeline, the retail pipeline) on one 2-shard
fleet against the same run on the CPU.  After the zamba2 path the
big/little cascade (``core/cascade.py``) runs with full-width zamba2-7b as
the big model and its 9-layer cut as the little one, and against the CPU
on two 9-layer models; the deepseek and musicgen paths come next, once
zamba2's weights are freed.  LLM training comes last: K6 and K8 under
autograd (the kernel forward, the plain version's VJP backward) against
autograd of their plain versions at every test shape and the training
shapes, one ``make_train_step`` step of zamba2-7b's 9-layer cut against
the CPU, and ``train_llm`` on zamba2-7b at full width cut to 17 layers
(1.604 B parameters, 4 x 512 tokens), then the same steps with remat.
Any failed check raises; nothing is caught.
The last three lines are the card's name and power limit, one JSON object
describing the kernels, and ``{"ok": true, "device": {...}}``.

``--parent DIR`` names another checkout (the parent commit unpacked with
``git archive``): its K2, K5, K1, K4b and K4a phases then run in a
subprocess before and after this tree's, on the same card, and their
device times are printed beside this tree's.

Without a CUDA device, or without the repository's ``src/repro_torch`` next
to it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 0

# the kernels the video path runs (K4a and the NMS kernel through its two
# NMS per flush)
VIDEO_KERNELS = ("region_filter_mask_batch", "crop_gather", "onevsall_scores",
                 "iou_matrix", "nms_greedy")


def h100():
    """The H100 SXM's peaks (NVIDIA data sheet; ``repro_torch.roofline.hw``):
    HBM bandwidth, fp32 outside the tensor cores and dense TF32 on them --
    the rates the bounds below divide by.  main() puts src/ on the path."""
    from repro_torch.roofline.hw import H100
    return H100


def bound_ms(nbytes: float, ops: float):
    chip = h100()
    t_bytes = nbytes / chip.hbm_bandwidth
    t_ops = ops / chip.peak_flops_fp32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tc_bound_ms(nbytes: float, mma_flops: float, simt_ops: float,
                bf16_flops: float = 0.0, tf32x2_flops: float = 0.0):
    """The bound of a kernel whose products run on the tensor cores in
    3xTF32 (three TF32 products for each fp32 one), ``bf16_flops`` of them
    as bf16 products at bf16's rate, ``tf32x2_flops`` of them (one operand
    a bf16 value, exact in tf32) as two TF32 products each, and the rest
    on the CUDA cores: the larger of the bytes' time and the units' times
    summed."""
    chip = h100()
    t_bytes = nbytes / chip.hbm_bandwidth
    x3 = mma_flops - bf16_flops - tf32x2_flops
    t_ops = ((3 * x3 + 2 * tf32x2_flops) / chip.peak_flops_tf32
             + bf16_flops / chip.peak_flops_bf16
             + simt_ops / chip.peak_flops_fp32)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bf16_bound_ms(nbytes: float, mma_flops: float, other_ops: float):
    """The bound of a kernel on bf16 operands: the bytes' time, or its
    bf16 products at the tensor cores' bf16 rate plus its other operations
    at fp32's rate on the CUDA cores, whichever is larger."""
    chip = h100()
    t_bytes = nbytes / chip.hbm_bandwidth
    t_ops = mma_flops / chip.peak_flops_bf16 + other_ops / chip.peak_flops_fp32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _self_device_us(event) -> float:
    """Device time of one kernel or copy event.  A host-side op (``aten::mm``)
    also reports a self device time, the time of the kernels it launched,
    which the profiler lists again as their own events: counting both
    doubles the device time, so a host-side op counts 0 here."""
    if str(getattr(event, "device_type", "")).endswith("CPU"):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_us_per_call(avgs, reps: int, once: bool = False):
    """Device time of one call from a profile of ``reps`` identical calls:
    each kernel's mean duration times its launches per call, or None (not
    measured) where the window lost events.  A kernel's launches per call
    are 1 with ``once`` (a call known to launch each of its kernels once),
    else its events over ``reps`` rounded up; a kernel with fewer events
    than ``reps`` times that lost some.  The profiler drops events (3 of 20
    in a run of K7, 6 of 30 of K5, 4 of 5 of K6 at 32k on an H100), and
    scaling a kernel's time by the share it kept printed K6 at a fifth of
    its time."""
    total = 0.0
    for e in avgs:
        us = _self_device_us(e)
        if us > 0:
            per_call = 1 if once else -(-e.count // reps)
            if e.count < reps * per_call:
                return None
            total += us / e.count * per_call
    return total


PROFILE_ATTEMPTS = 3     # windows profiled before a device time is null


def profile_device(torch, fn, reps: int = 1, once: bool = False):
    """Run ``fn`` ``reps`` times under torch.profiler (CUPTI); return the
    device time per call in ms and the key averages; ``once`` as in
    :func:`device_us_per_call`.  A window that recorded no device time
    (CUPTI has lost a whole window on an H100) or lost some events is
    taken again, up to PROFILE_ATTEMPTS windows, before the time is
    reported as None; a line says when a retry was needed."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        total_us = device_us_per_call(avgs, reps, once)
        if attempt:
            print(f"  profile_device: retry {attempt} of a window of {reps} "
                  f"call(s) whose profile lost device events: "
                  + ("complete" if total_us else "lost events again"
                     + (": null" if attempt + 1 == PROFILE_ATTEMPTS else "")))
        if total_us:
            return total_us / 1e3, avgs
    return None, avgs


def in_turns(fns, timer):
    """Each of ``fns`` (name -> callable) timed by ``timer(fn)`` in turns,
    forward then backward (a, b, b, a): the host's speed drifts within a
    run.  Returns name -> [turn times]."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(timer(fns[name]))
    return times


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host time per call of ``fn`` in microseconds over ``calls`` calls
    (perf_counter, no synchronisation inside the window)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def measure(torch, fn, reps: int = 30, once: bool = False):
    """(per-call time from CUDA events, device time per call from the
    profiler).  The first includes the host's launch path whenever the
    card waits for it; the second is the kernels' own execution time."""
    return (time_ms(torch, fn, reps),
            profile_device(torch, fn, reps, once)[0])


def versus_library(torch, kernel, library, reps: int = 30,
                   once: bool = False):
    """A kernel and its library yardstick timed in turns (kernel, library,
    library, kernel), each with its device time from the profiler (the
    kernel's with ``once`` as in :func:`device_us_per_call`):
    ((kernel ms per call, device ms), (library ms, device ms), turns)."""
    turns = in_turns({"kernel": kernel, "library": library},
                     lambda fn: time_ms(torch, fn, reps))
    return ((statistics.mean(turns["kernel"]),
             profile_device(torch, kernel, reps, once)[0]),
            (statistics.mean(turns["library"]),
             profile_device(torch, library, reps)[0]), turns)


def _report_turns(tag, turns, row, lib_name, card):
    """The turns' per-call times and the library's device time, as
    :func:`flag_below_bound` left it in ``row``."""
    k, lib = turns["kernel"], turns["library"]
    print(f"{tag} in turns (kernel, {lib_name}, {lib_name}, kernel): kernel "
          f"{k[0]:.4f}, {k[1]:.4f} ms per call; {lib_name} {lib[0]:.4f}, "
          f"{lib[1]:.4f} ms per call ({fmt(row.get('library_device_ms'))} "
          f"on the device) [{card}]")


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def report_uncapped(tag, row, timed, nocap, turns, card):
    """A K6 or K7 row's yardstick where no PyTorch call computes its
    function: SDPA on the same operands without the softcap and the
    window, in turns with the kernel (:func:`versus_library`), kept apart
    from ``library_ms`` (which stays None) as not the same function."""
    row.update(sdpa_uncapped_ms=nocap[0], sdpa_uncapped_device_ms=nocap[1],
               sdpa_uncapped_turns_ms=turns)
    k, lib = turns["kernel"], turns["library"]
    print(f"{tag} in turns with SDPA without the softcap and the window "
          f"(not the same function): kernel {k[0]:.4f}, {k[1]:.4f} ms per "
          f"call ({fmt(timed[1])} on the device), SDPA {lib[0]:.4f}, "
          f"{lib[1]:.4f} ms per call ({fmt(nocap[1])} on the device) "
          f"[{card}]")


def kernel_instance(mangled: str):
    """A mangled entry function's kernel name with its template arguments
    (``float``, ``bf16``, integers): the name is the ``*_kernel`` whose
    length the digits before it give."""
    import re
    for m in re.finditer(r"(?=([a-z][a-z0-9_]*?_kernel))", mangled):
        name = m.group(1)
        if not mangled[:m.start()].endswith(str(len(name))):
            continue
        rest = mangled[m.start() + len(name):]
        args = []
        if rest.startswith("I"):
            for tok in re.finditer(r"L[ib](-?\d+)E|(13__nv_bfloat16)|(f)",
                                   rest[1:rest.find("EE") + 1]):
                args.append(tok.group(1) or ("bf16" if tok.group(2)
                                             else "float"))
        return name + (f"<{', '.join(args)}>" if args else "")
    return None


def ptxas_summary(build_log: str):
    """One line per compiled kernel: its name with the template arguments,
    then ptxas's register, barrier, shared-memory and spill report."""
    import re
    name, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            name = kernel_instance(m.group(1))
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and name:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spill}"
            name = None


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phases: kernel vs plain version on the card, at the path's shapes
# ---------------------------------------------------------------------------
def _row(name, source, replaces, shape, err, timed, plain, lib, nbytes, ops):
    b_ms, b_by = bound_ms(nbytes, ops)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                shape=shape, max_abs_err=err, ms=timed[0],
                device_ms=timed[1], plain_ms=plain[0],
                plain_device_ms=plain[1], bound_ms=b_ms, bound_by=b_by,
                library_ms=lib)


DEVICE_KEYS = ("device_ms", "plain_device_ms", "library_device_ms")


def flag_below_bound(row) -> str:
    """Each device time of ``row`` (kernel, plain version, library) that
    reads below the row's least bound (``bound_ms``, or ``bound_tc_ms``
    where that is lower) moves to ``<key>_below_bound`` and reads None: no
    call computes the function faster than its bound, so such a reading is
    the timer's fault, not a time.  Returns the note the row's line adds."""
    bound = min(row["bound_ms"], row.get("bound_tc_ms") or row["bound_ms"])
    notes = []
    for key in DEVICE_KEYS:
        ms = row.get(key)
        if ms is not None and ms < bound:
            row[key], row[key + "_below_bound"] = None, ms
            notes.append(f"{key} read {ms:.6f} ms, below the bound "
                         f"{bound:.6f} ms: not a time")
    return "".join(f"; {n}" for n in notes)


def _report(tag, row, card, lib_name=None):
    flags = flag_below_bound(row)
    lib = ("" if lib_name is None else
           f", {lib_name} {fmt(row['library_ms'])}")
    print(f"{tag}: kernel {fmt(row['ms'])} per call "
          f"({fmt(row['device_ms'])} on the device), plain "
          f"{fmt(row['plain_ms'])} ({fmt(row['plain_device_ms'])} on the "
          f"device){lib}, bound {row['bound_ms']:.6f} ms ({row['bound_by']})"
          f"{flags} [{card}]")


# valid accepted boxes a frame in the sparse cases: what NMS keeps on the
# serving path is a few a frame (the main path's own operands are timed too)
SPARSE_ACCEPTED = 4


def kernel_ptxas(name: str):
    """ptxas's report of one kernel (every template instance of it)."""
    from repro_torch.kernels import _build
    return [line for line in ptxas_summary(_build.build_log)
            if line.startswith(name)]



def filter_bound(f, n, m, n_acc):
    """K1's / K4b's bound, computed as it was before their redesign so
    that the rows compare across versions: every input byte once, 14
    operations for every pair of a proposal with a valid accepted box, 5
    per box area, 5 per proposal's terms."""
    nbytes = f * n * (16 + 1 + 4 + 1) + f * m * (16 + 1)
    ops = 14 * n_acc * n + 5 * f * (n + m) + 5 * f * n
    return nbytes, ops


def filter_sparse(torch, kernel, plain, shape: str, bound, what: str,
                  card) -> dict:
    """``kernel()`` on a sparse accepted set: bit-equal to ``plain()`` and
    timed beside it; the numbers that the row keeps as ``sparse``."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what} differs from the plain version at "
                             f"{int((got != want).sum())} positions")
    row = _row("region_filter_mask", "", "", shape, 0.0,
               measure(torch, kernel, once=True), measure(torch, plain),
               None, *bound)
    _report(f"{what}: masks equal", row, card)
    return {k: row[k] for k in ("ms", "device_ms", "plain_ms",
                                "plain_device_ms", "bound_ms", "bound_by")}


def filter_corners_on_card(torch, kernel, plain, what: str, per_frame):
    """Every case of testing.filter_corner_cases (NaN coordinates, theta_iou
    <= 0, empty and odd-sized accepted sets, ragged N, two passes) on the
    card, bit-equal to the plain version (frame by frame for K4b)."""
    from repro_torch.testing import filter_corner_cases
    cases = filter_corner_cases()
    for name, (arrays, kw) in cases.items():
        args = [torch.as_tensor(a, device="cuda") for a in arrays]
        frames = ([[a[i] for a in args] for i in range(args[0].shape[0])]
                  if per_frame else [args])
        for fr in frames:
            got, want = kernel(*fr, **kw), plain(*fr, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: corner case {name} differs "
                                     f"from the plain version")
    return len(cases)


def phase_region_filter(torch, np, card):
    from repro_torch.kernels import iou_filter as ik
    from repro_torch.testing import filter_case, rand_boxes
    f, n, m = 32, 256, 256
    rng = np.random.default_rng(SEED)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    prop, acc = t(rand_boxes(rng, (f, n))), t(rand_boxes(rng, (f, m)))
    pv, av = t(rng.random((f, n)) > 0.2), t(rng.random((f, m)) > 0.2)
    loc = t(rng.random((f, n), dtype=np.float32))
    kw = dict(theta_loc=0.5, theta_iou=0.3, theta_back=0.5)
    got = ik.region_filter_mask_batch(prop, pv, acc, av, loc, **kw)
    want = ik.region_filter_mask_batch_ref(prop, pv, acc, av, loc, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"K1 mask differs from the plain version at "
            f"{int((got != want).sum())} of {got.numel()} positions")
    # once: one device kernel a call, whatever share of its events the
    # profiler keeps
    timed = measure(torch, lambda: ik.region_filter_mask_batch(
        prop, pv, acc, av, loc, **kw), once=True)
    plain = measure(torch, lambda: ik.region_filter_mask_batch_ref(
        prop, pv, acc, av, loc, **kw))
    row = _row("region_filter_mask_batch", "src/repro_torch/csrc/iou_filter.cu",
               "src/repro/kernels/iou_filter.py:174", f"F={f} N={n} M={m}",
               0.0, timed, plain, None, *filter_bound(f, n, m, int(av.sum())))
    _report(f"K1 region_filter_mask_batch F={f} N={n} M={m}: masks equal",
            row, card)
    # the serving path's density: SPARSE_ACCEPTED valid accepted boxes a
    # frame, the other operands as above
    av_s = t(np.argsort(rng.random((f, m)), -1) < SPARSE_ACCEPTED)
    row["sparse"] = filter_sparse(
        torch, lambda: ik.region_filter_mask_batch(
            prop, pv, acc, av_s, loc, **kw),
        lambda: ik.region_filter_mask_batch_ref(
            prop, pv, acc, av_s, loc, **kw),
        f"F={f} N={n} M={m}", filter_bound(f, n, m, int(av_s.sum())),
        f"K1 region_filter_mask_batch sparse F={f} N={n} M={m} "
        f"({SPARSE_ACCEPTED} valid accepted a frame)", card)
    # ragged: N and M not multiples of a block's 8 proposals or a pass
    args = [t(a) for a in filter_case(7, 130, 70, seed=SEED)]
    if not torch.equal(ik.region_filter_mask_batch(*args, **kw),
                       ik.region_filter_mask_batch_ref(*args, **kw)):
        raise AssertionError("K1 ragged F=7 N=130 M=70 differs from the "
                             "plain version")
    corners = filter_corners_on_card(
        torch, ik.region_filter_mask_batch, ik.region_filter_mask_batch_ref,
        "K1", per_frame=False)
    row["ptxas"] = kernel_ptxas("region_filter_kernel")
    print(f"K1: ragged F=7 N=130 M=70 and {corners} corner cases (NaN "
          f"coordinates among them) masks equal; ptxas: "
          + "; ".join(row["ptxas"]) + f" [{card}]")
    return row


def phase_region_filter_served(torch, card, served, row):
    """K1 on the operands of the main path's last fused flush (``served``:
    the arguments and thresholds that ``split_regions`` handed
    ``ops.region_filter_mask_batch``), against its plain version and
    timed; the numbers go into the K1 row as ``served``."""
    from repro_torch.kernels import iou_filter as ik
    args, kw = served
    got = ik.region_filter_mask_batch(*args, **kw)
    if not torch.equal(got, ik.region_filter_mask_batch_ref(*args, **kw)):
        raise AssertionError("K1 on the main path's operands differs from "
                             "the plain version")
    f, n, m = args[0].shape[0], args[0].shape[1], args[2].shape[1]
    n_prop, n_acc = int(args[1].sum()), int(args[3].sum())
    timed = measure(torch, lambda: ik.region_filter_mask_batch(*args, **kw),
                    once=True)
    plain = measure(torch, lambda: ik.region_filter_mask_batch_ref(*args,
                                                                   **kw))
    served_row = _row("region_filter_mask_batch", "", "",
                      f"F={f} N={n} M={m}", 0.0, timed, plain, None,
                      *filter_bound(f, n, m, n_acc))
    _report(f"K1 region_filter_mask_batch served F={f} N={n} M={m} (the "
            f"last fused flush: {n_prop} valid proposals, {n_acc} valid "
            f"accepted boxes, {int(got.sum())} kept): masks equal",
            served_row, card)
    row["served"] = {k: served_row[k] for k in (
        "shape", "ms", "device_ms", "plain_ms", "plain_device_ms",
        "bound_ms", "bound_by")}
    row["served"].update(valid_proposals=n_prop, valid_accepted=n_acc)


class LastCall:
    """While a ``with`` block lasts, ``module.name`` is wrapped so that the
    last call's arguments are kept (references, no copies); the wrapped
    function runs once per call, as before."""

    def __init__(self, module, name):
        self.module, self.name, self.args = module, name, None

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def call(*args, **kw):
            self.args = (args, kw)
            return self.fn(*args, **kw)
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def crop_tap_pixels(np, boxes, idxs, hw, out_hw) -> int:
    """The distinct in-frame pixels that the bilinear taps of the bucket
    rows ``idxs`` touch: the least the crop gather must read."""
    f, n = boxes.shape[:2]
    fi = idxs[0].clip(0, f - 1)
    bx = boxes[fi, idxs[1].clip(0, n - 1)]
    lo = []
    for ax, (size, out) in enumerate(zip(hw, out_hw)):
        a, b = bx[:, 1 - ax], bx[:, 3 - ax]      # y1, y2 then x1, x2
        lin = np.linspace(0.0, 1.0, out, dtype=np.float32)
        m = np.float32(size - 1)
        pos = a[:, None] * m + ((b - a) * m)[:, None] * lin
        lo.append(np.floor(pos).astype(np.int64))
    touched = np.zeros((f, *hw), bool)
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = lo[0][:, :, None] + dy, lo[1][:, None, :] + dx
            ff, yy, xx = np.broadcast_arrays(fi[:, None, None], yy, xx)
            ok = (yy >= 0) & (yy < hw[0]) & (xx >= 0) & (xx < hw[1])
            touched[ff[ok], yy[ok], xx[ok]] = True
    return int(touched.sum())


def crop_grid_sample(torch, frames, boxes, idx_t, out_hw):
    """The library yardstick's inputs and call: one ``grid_sample`` over
    the bucket rows' frames, with the gather and the sample grid built
    outside the timed call."""
    import torch.nn.functional as F
    f, n = boxes.shape[:2]
    b = idx_t.shape[1]
    fi = idx_t[0].long().clamp(0, f - 1)
    bx = boxes[fi, idx_t[1].long().clamp(0, n - 1)]
    lin_y = torch.linspace(0, 1, out_hw[0], device="cuda")
    lin_x = torch.linspace(0, 1, out_hw[1], device="cuda")
    gy = (bx[:, 1:2] + (bx[:, 3:4] - bx[:, 1:2]) * lin_y) * 2 - 1
    gx = (bx[:, 0:1] + (bx[:, 2:3] - bx[:, 0:1]) * lin_x) * 2 - 1
    grid = torch.stack([gx[:, None, :].expand(b, *out_hw),
                        gy[:, :, None].expand(b, *out_hw)], -1)
    src = frames.permute(0, 3, 1, 2)[fi].contiguous()
    return lambda: F.grid_sample(src, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


CROP_FRAMES, CROP_BOXES, CROP_HW, CROP_OUT = 32, 256, (128, 128), (40, 40)


def crop_inputs(torch, np, b, n_valid, rng):
    """Frames and boxes of the K2 phase and a bucket of ``b`` rows, the
    first ``n_valid`` valid, the rest out-of-bounds pad rows."""
    idxs = np.zeros((3, b), np.int32)
    idxs[0] = CROP_FRAMES
    idxs[0, :n_valid] = rng.integers(0, CROP_FRAMES, n_valid)
    idxs[1, :n_valid] = rng.integers(0, CROP_BOXES, n_valid)
    return idxs, torch.as_tensor(idxs, device="cuda")


def phase_crop_gather(torch, np, card):
    from repro_torch.kernels import crop_gather as cg
    from repro_torch.testing import rand_boxes
    f, n, hw, out_hw = CROP_FRAMES, CROP_BOXES, CROP_HW, CROP_OUT
    rng = np.random.default_rng(SEED + 1)
    frames = torch.as_tensor(rng.random((f, *hw, 3), dtype=np.float32),
                             device="cuda")
    boxes = torch.as_tensor(rand_boxes(rng, (f, n)), device="cuda")
    main_row = None
    for b, n_valid in ((4, 2), (128, 100), (200, 200)):
        idxs, idx_t = crop_inputs(torch, np, b, n_valid, rng)
        got = cg.crop_gather(frames, boxes, idx_t, out_hw=out_hw)
        want = cg.crop_gather_ref(frames, boxes, idx_t, out_hw=out_hw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K2 crops at B={b} differ from the plain version: max abs "
                f"{float((got - want).abs().max())}")
        timed, lib, turns = versus_library(
            torch, lambda: cg.crop_gather(frames, boxes, idx_t,
                                          out_hw=out_hw),
            crop_grid_sample(torch, frames, boxes, idx_t, out_hw),
            once=True)
        plain = measure(torch, lambda: cg.crop_gather_ref(
            frames, boxes, idx_t, out_hw=out_hw))
        out_el = b * out_hw[0] * out_hw[1] * 3
        # read bytes: each distinct in-frame tap pixel once, plus the boxes,
        # the index rows and the sample grid
        taps = crop_tap_pixels(np, boxes.cpu().numpy(), idxs, hw, out_hw)
        nbytes = (4 * out_el + taps * 3 * 4 + b * 16 + 2 * b * 4
                  + 4 * sum(out_hw))
        ops = b * out_hw[0] * out_hw[1] * (14 + 7 * 3)
        row = _row("crop_gather", "src/repro_torch/csrc/crop_gather.cu",
                   "src/repro/kernels/crop_gather.py:42",
                   f"B={b} F={f} 128x128x3 -> 40x40x3", 0.0, timed, plain,
                   lib[0], nbytes, ops)
        row.update(library_device_ms=lib[1], turns_ms=turns)
        tag = f"K2 crop_gather B={b} ({n_valid} valid) F={f}"
        _report(f"{tag}: bit-equal", row, card, "grid_sample")
        _report_turns(tag, turns, row, "grid_sample", card)
        if b == 128:                       # the path's largest bucket
            main_row = row
    main_row["host_us"] = phase_k2_host_path(torch, np, card)
    return main_row


def phase_k2_host_path(torch, np, card, calls: int = 1000):
    """Where K2's call time goes on the host at B = 128: the wrapper, the
    shared launch path ``_build.launch`` alone, the bare ctypes call with
    the stream handle read once, the operand check and the output's
    allocation alone, and ``grid_sample`` on its prebuilt inputs, in
    microseconds per call over ``calls`` calls, in turns."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import crop_gather as cg
    from repro_torch.testing import rand_boxes
    f, n, hw, (oh, ow) = CROP_FRAMES, CROP_BOXES, CROP_HW, CROP_OUT
    b = 128
    rng = np.random.default_rng(SEED + 1)
    frames = torch.as_tensor(rng.random((f, *hw, 3), dtype=np.float32),
                             device="cuda")
    boxes = torch.as_tensor(rand_boxes(rng, (f, n)), device="cuda")
    _, idx_t = crop_inputs(torch, np, b, 100, rng)
    out = cg.crop_gather(frames, boxes, idx_t, out_hw=(oh, ow))
    lin_y, lin_x = (torch.as_tensor(np.linspace(0, 1, k, dtype=np.float32),
                                    device="cuda") for k in (oh, ow))
    sizes = cg.CropArgs(lin_y.data_ptr(), lin_x.data_ptr(), b, f, *hw, 3, n,
                        oh, ow)
    name = "vpaas_crop_gather"
    import ctypes
    args = (frames.data_ptr(), boxes.data_ptr(), idx_t.data_ptr(),
            out.data_ptr(), ctypes.addressof(sizes))
    bare = getattr(_build.library(), name)
    stream = torch.cuda.current_stream().cuda_stream
    operands = (("frames", frames, torch.float32, None),
                ("boxes", boxes, torch.float32, (f, n, 4)),
                ("idxs", idx_t, torch.int32, None))
    turns = in_turns({
        "wrapper": lambda: cg.crop_gather(frames, boxes, idx_t,
                                          out_hw=(oh, ow)),
        "_build.launch": lambda: _build.launch(name, *args),
        "bare ctypes call": lambda: bare(*args, stream),
        "check_operands": lambda: _build.check_operands(*operands),
        "new_empty": lambda: frames.new_empty((b, oh, ow, 3)),
        "grid_sample": crop_grid_sample(torch, frames, boxes, idx_t,
                                        (oh, ow))},
        lambda fn: host_us(torch, fn, calls))
    us = {what: statistics.mean(t) for what, t in turns.items()}
    print(f"K2 host path B={b} {oh}x{ow}x3, us per call over {calls} calls "
          f"(two turns): " + ", ".join(f"{what} {t:.2f}"
                                       for what, t in us.items())
          + f" [{card}]")
    return us


def phase_onevsall(torch, np, card):
    from repro_torch.kernels import onevsall as ov
    d1, c = 129, 8
    rng = np.random.default_rng(SEED + 2)
    main_row = None
    for b, g in ((1024, 1), (128, 8), (128, 64)):
        # features are relu outputs plus the bias-absorbing 1
        x = np.maximum(rng.normal(0, 1, (b, d1)), 0).astype(np.float32)
        x[:, -1] = 1.0
        ws = (rng.normal(0, 1, (g, d1, c)) / np.sqrt(d1)).astype(np.float32)
        x_t = torch.as_tensor(x, device="cuda")
        ws_t = torch.as_tensor(ws, device="cuda")
        widx = (None if g == 1 else torch.as_tensor(
            rng.integers(0, g, b).astype(np.int32), device="cuda"))
        got = ov.onevsall_scores(x_t, ws_t, widx)
        want = ov.onevsall_scores_ref(x_t, ws_t, widx)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= 1e-6:
            raise AssertionError(f"K3 at B={b} G={g}: max abs error {err} "
                                 "exceeds 1e-6")
        kernel = lambda: ov.onevsall_scores(x_t, ws_t, widx)  # noqa: E731
        plain = measure(torch, lambda: ov.onevsall_scores_ref(x_t, ws_t,
                                                              widx))
        lib = turns = None
        if g == 1:
            w0 = ws_t[0]
            timed, lib, turns = versus_library(
                torch, kernel, lambda: torch.sigmoid(torch.mm(x_t, w0)))
        else:
            timed = measure(torch, kernel)
        used = 1 if widx is None else int(widx.unique().numel())
        nbytes = ((b * d1 + used * d1 * c + b * c) * 4
                  + (b * 4 if g > 1 else 0))
        ops = b * c * (2 * d1 + 4)
        row = _row("onevsall_scores", "src/repro_torch/csrc/onevsall.cu",
                   "src/repro/kernels/onevsall.py:35",
                   f"B={b} G={g} D1={d1} C={c}", err, timed, plain,
                   None if lib is None else lib[0], nbytes, ops)
        tag = f"K3 onevsall_scores B={b} G={g} D1={d1} C={c}"
        if g == 1:
            row.update(library_device_ms=lib[1], turns_ms=turns)
        _report(f"{tag}: max abs err {err:.3e}", row, card,
                "sigmoid(mm)" if g == 1 else None)
        if g == 1:                          # the full-budget classify batch
            _report_turns(tag, turns, row, "sigmoid(mm)", card)
            row["host_us"] = phase_k3_host_path(torch, np, card)
            main_row = row
    return main_row


def phase_k3_host_path(torch, np, card, calls: int = 1000):
    """Where K3's call time goes on the host at B = 1024: the wrapper, the
    shared launch path ``_build.launch`` alone, the bare ctypes call with
    the stream handle read once, and the per-call stream read the launch
    path made before (a ``torch.cuda.Stream`` object), in microseconds per
    call over ``calls`` calls; ``sigmoid(mm)`` beside them."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import onevsall as ov
    b, d1, c = 1024, 129, 8
    rng = np.random.default_rng(SEED + 2)
    x = torch.as_tensor(rng.normal(0, 1, (b, d1)).astype(np.float32),
                        device="cuda")
    ws = torch.as_tensor(rng.normal(0, 1, (1, d1, c)).astype(np.float32),
                         device="cuda")
    w0 = ws[0]
    out = torch.empty((b, c), device="cuda")
    name = "vpaas_onevsall_scores"
    args = (x.data_ptr(), ws.data_ptr(), None, out.data_ptr(), b, d1, c, 1)
    bare = getattr(_build.library(), name)
    stream = torch.cuda.current_stream().cuda_stream
    turns = in_turns({
        "wrapper": lambda: ov.onevsall_scores(x, ws),
        "_build.launch": lambda: _build.launch(name, *args),
        "bare ctypes call": lambda: bare(*args, stream),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "sigmoid(mm)": lambda: torch.sigmoid(torch.mm(x, w0))},
        lambda fn: host_us(torch, fn, calls))
    us = {what: statistics.mean(t) for what, t in turns.items()}
    print(f"K3 host path B={b} D1={d1} C={c}, us per call over {calls} "
          f"calls (two turns): " + ", ".join(
              f"{what} {t:.2f}" for what, t in us.items()) + f" [{card}]")
    return us


# K5's one step: one row (the learner's step), one full label-budget
# buffer, the trainer's max_buffer, and a ragged case
UPDATE_SHAPES = ((1, 129, 8), (256, 129, 8), (2048, 129, 8), (130, 17, 10))
# K5's replay: a round's buffer on the plane (its rounds replay 16 to 64
# instances), the inline learner's mean buffer (473 instances over 17
# updates), and the label budget; the learning path's 2 passes
REPLAY_SHAPES = ((16, 129, 8), (28, 129, 8), (64, 129, 8), (256, 129, 8))
REPLAY_PASSES = 2


def update_smem_bytes(d1: int, c: int) -> int:
    """The K5 step kernel's dynamic shared memory: a tile's x rows and
    residuals, and W at an odd row stride when it fits beside them."""
    from repro_torch.kernels import onevsall_update as ou
    tile = 4 * ou.tile_rows(d1, c) * (d1 + c)
    w = 4 * d1 * (c | 1)
    return tile + (w if tile + w <= ou.MAX_SMEM else 0)


def phase_onevsall_update(torch, np, card):
    from repro_torch.kernels import _build
    from repro_torch.kernels import onevsall_update as ou
    from repro_torch.testing import (UPDATE_ETA, UPDATE_RTOL, rel_err,
                                     update_case)
    ptxas = [line for line in ptxas_summary(_build.build_log)
             if line.startswith("onevsall_update")]
    rows = []
    for b, d1, c in UPDATE_SHAPES:
        x, y, w = (torch.as_tensor(a, device="cuda")
                   for a in update_case(b, d1, c, seed=SEED))
        got = ou.onevsall_update(x, y, w, eta=UPDATE_ETA)
        want = ou.onevsall_update_ref(x, y, w, eta=UPDATE_ETA)
        torch.cuda.synchronize()
        for _ in range(3):
            if not torch.equal(ou.onevsall_update(x, y, w, eta=UPDATE_ETA),
                               got):
                raise AssertionError(f"K5 at B={b}: two launches on the "
                                     "same inputs differ")
        err = float((got - want).abs().max())
        rel = rel_err(got.cpu(), want.cpu())
        if not (rel <= UPDATE_RTOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K5 at B={b} D1={d1} C={c}: error {rel} "
                                 f"of the output scale exceeds {UPDATE_RTOL}")
        # library yardstick: the same function as a cuBLAS addmm over a
        # matmul, a sigmoid and a subtraction (four launches, not one call)
        timed, lib, turns = versus_library(
            torch, lambda: ou.onevsall_update(x, y, w, eta=UPDATE_ETA),
            lambda: torch.addmm(w, x.t(), torch.sigmoid(x @ w) - y,
                                alpha=-UPDATE_ETA), once=True)
        plain = measure(torch, lambda: ou.onevsall_update_ref(
            x, y, w, eta=UPDATE_ETA))
        nbytes = 4 * (b * d1 + b * c + 2 * d1 * c)
        ops = 4 * b * d1 * c + 2 * d1 * c
        row = _row("onevsall_update",
                   "src/repro_torch/csrc/onevsall_update.cu",
                   "src/repro/kernels/onevsall.py:86", f"B={b} D1={d1} C={c}",
                   err, timed, plain, lib[0], nbytes, ops)
        row.update(library_device_ms=lib[1], turns_ms=turns)
        tiles = -(-b // ou.tile_rows(d1, c))
        tag = f"K5 onevsall_update B={b} D1={d1} C={c}"
        _report(f"{tag}: max abs err {err:.3e} ({rel:.2e} of the output "
                f"scale), bit-identical run to run, {tiles} tile(s)"
                + (" + combine" if tiles > 1 else "")
                + f", {update_smem_bytes(d1, c)} B dyn. smem", row, card,
                "cuBLAS composition addmm(w, x^T, sigmoid(x w) - y)")
        _report_turns(tag, turns, row, "addmm composition", card)
        rows.append(row)
    for line in ptxas:
        print(f"  K5 ptxas: {line}")
    return rows


def phase_onevsall_replay(torch, np, card):
    """K5's replay on the card: one launch per buffer, bit-equal to the
    loop of one-row launches and within LEARN_RTOL of the plain loop;
    its time per call and per step beside the loop of one-row launches'
    and the plain loop's.  Returns the row of the plane's largest round."""
    from repro_torch.kernels import onevsall_update as ou
    from repro_torch.testing import (LEARN_RTOL, UPDATE_ETA, rel_err,
                                     update_case)
    passes, main_row = REPLAY_PASSES, None
    for n, d1, c in REPLAY_SHAPES:
        xs, ys, w = (torch.as_tensor(a, device="cuda")
                     for a in update_case(n, d1, c, seed=SEED + 5))
        steps = n * passes

        def loop():
            v = w
            for _ in range(passes):
                for i in range(n):
                    v = ou.onevsall_update(xs[i:i + 1], ys[i:i + 1], v,
                                           eta=UPDATE_ETA)
            return v

        def replay():
            return ou.onevsall_replay(xs, ys, w, eta=UPDATE_ETA,
                                      passes=passes)

        got, by_loop = replay(), loop()
        want = ou.onevsall_replay_ref(xs, ys, w, eta=UPDATE_ETA,
                                      passes=passes)
        torch.cuda.synchronize()
        if not (torch.equal(got, by_loop) and torch.equal(replay(), got)):
            raise AssertionError(f"K5 replay N={n}: not bit-equal to the "
                                 "loop of one-row launches or to itself")
        err = float((got - want).abs().max())
        rel = rel_err(got.cpu(), want.cpu())
        if not (rel <= LEARN_RTOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K5 replay N={n}: error {rel} of the "
                                 f"output scale exceeds {LEARN_RTOL}")
        timed = measure(torch, replay, once=True)
        by_steps = measure(torch, loop, reps=5)
        plain = measure(torch, lambda: ou.onevsall_replay_ref(
            xs, ys, w, eta=UPDATE_ETA, passes=passes), reps=3)
        nbytes = 4 * (n * d1 + n * c + 2 * d1 * c)
        ops = steps * (4 * d1 * c + 2 * d1 * c)
        row = _row("onevsall_update",
                   "src/repro_torch/csrc/onevsall_update.cu",
                   "src/repro/kernels/onevsall.py:86",
                   f"replay N={n} passes={passes} D1={d1} C={c}", err,
                   timed, plain, None, nbytes, ops)
        per_step = (None if timed[1] is None
                    else timed[1] * 1e3 / steps)
        row.update(steps_per_call=steps, device_us_per_step=per_step,
                   single_step_launches_ms=by_steps[0],
                   single_step_launches_device_ms=by_steps[1])
        _report(f"K5 replay N={n} x {passes} passes ({steps} steps) D1={d1} "
                f"C={c}: bit-equal to {steps} one-row launches, max abs err "
                f"{err:.3e} ({rel:.2e} of the output scale) against the "
                f"plain loop; "
                + ("per step not measured" if per_step is None
                   else f"{per_step:.3f} us per step on the device")
                + f"; the loop of one-row launches {fmt(by_steps[0])} per "
                f"call ({fmt(by_steps[1])} on the device)", row, card)
        if n == 64:
            main_row = row
    return main_row


# K4a at the flush's NMS shape, then shapes of the JAX package's IoU sweep
IOU_SHAPES = ((32, 256, 256), (1, 200, 100), (1, 13, 7))
# K4b at the region budget, then a ragged case
FRAME_FILTER_SHAPES = ((256, 256), (130, 70))


def phase_iou_matrix(torch, np, card):
    """K4a at its three shapes, bit-equal to its plain version and timed;
    returns the rows (the flush's NMS shape first)."""
    from repro_torch.kernels import iou_matrix as im
    from repro_torch.testing import iou_case
    rows = []
    for b, n, m in IOU_SHAPES:
        a, c = (torch.as_tensor(x, device="cuda")
                for x in iou_case(b, n, m, seed=SEED))
        got = im.iou_matrix(a, c)
        want = im.iou_matrix_ref(a, c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K4a at B={b} N={n} M={m} differs from the plain version "
                f"at {int((got != want).sum())} of {got.numel()} entries")
        # once: one device kernel a call
        timed = measure(torch, lambda: im.iou_matrix(a, c), once=True)
        plain = measure(torch, lambda: im.iou_matrix_ref(a, c))
        # each box read once, the matrix written once; 13 ops per pair
        # (two overlaps, the product, the union, its floor, the division)
        # and 5 per box area
        nbytes = 4 * (4 * b * (n + m) + b * n * m)
        ops = 13 * b * n * m + 5 * b * (n + m)
        row = _row("iou_matrix", "src/repro_torch/csrc/iou_filter.cu",
                   "src/repro/kernels/iou_filter.py:45",
                   f"B={b} N={n} M={m}", 0.0, timed, plain, None, nbytes,
                   ops)
        _report(f"K4a iou_matrix B={b} N={n} M={m}: bit-equal", row, card)
        rows.append(row)
    rows[0]["ptxas"] = kernel_ptxas("iou_matrix_kernel")
    print("K4a ptxas: " + "; ".join(rows[0]["ptxas"]) + f" [{card}]")
    return rows


def phase_frame_filter(torch, np, card):
    from repro_torch.kernels import region_filter_mask as rf
    from repro_torch.testing import FILTER_KW, frame_filter_case
    main_row = None
    for n, m in FRAME_FILTER_SHAPES:
        args = [torch.as_tensor(x, device="cuda")
                for x in frame_filter_case(n, m, seed=SEED)]
        got = rf.region_filter_mask(*args, **FILTER_KW)
        want = rf.region_filter_mask_ref(*args, **FILTER_KW)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K4b at N={n} M={m}: mask differs from the plain version "
                f"at {int((got != want).sum())} of {n} proposals")
        timed = measure(torch, lambda: rf.region_filter_mask(
            *args, **FILTER_KW), once=True)
        plain = measure(torch, lambda: rf.region_filter_mask_ref(
            *args, **FILTER_KW))
        row = _row("region_filter_mask", "src/repro_torch/csrc/iou_filter.cu",
                   "src/repro/kernels/iou_filter.py:99", f"N={n} M={m}", 0.0,
                   timed, plain, None,
                   *filter_bound(1, n, m, int(args[3].sum())))
        _report(f"K4b region_filter_mask N={n} M={m}: masks equal", row,
                card)
        if main_row is None:                # the region budget
            main_row = row
            sparse = list(args)
            rng = np.random.default_rng(SEED + 4)
            sparse[3] = torch.as_tensor(
                np.argsort(rng.random(m)) < SPARSE_ACCEPTED, device="cuda")
            row["sparse"] = filter_sparse(
                torch, lambda: rf.region_filter_mask(*sparse, **FILTER_KW),
                lambda: rf.region_filter_mask_ref(*sparse, **FILTER_KW),
                f"N={n} M={m}", filter_bound(1, n, m, SPARSE_ACCEPTED),
                f"K4b region_filter_mask sparse N={n} M={m} "
                f"({SPARSE_ACCEPTED} valid accepted)", card)
    corners = filter_corners_on_card(torch, rf.region_filter_mask,
                                     rf.region_filter_mask_ref, "K4b",
                                     per_frame=True)
    main_row["ptxas"] = kernel_ptxas("region_filter_kernel")
    print(f"K4b: {corners} corner cases frame by frame (NaN coordinates "
          f"among them) masks equal [{card}]")
    return main_row


NMS_REPLACES = ("src/repro/kernels/ref.py:293 nms_mask (jax.lax.fori_loop; "
                "no Pallas kernel)")


def nms_candidates(torch, scores, valid):
    """Each frame's candidates, the rows the NMS kernel reads: valid boxes
    with a score > -1e30, none in a frame with a valid NaN score."""
    cand = (valid & (scores > -1e30)).sum(-1)
    bad = (valid & torch.isnan(scores)).any(-1)
    return [int(c) for c in torch.where(bad, 0, cand).reshape(-1).tolist()]


def nms_bound(n: int, candidates):
    """NMS's bound from the data (``candidates``: each frame's, as
    :func:`nms_candidates` counts them): each candidate's IoU row read once
    (4N bytes), each box's score, valid flag and keep once (6 bytes); one
    comparison per element of those rows and one per pair of a frame's
    candidates (their ranks).  The rows are priced at HBM's rate, though
    K4a's default-cached stores leave the matrix in L2 for the kernel (and
    the timing loop reads it from there): the floor from L2 is lower."""
    rows = sum(candidates)
    nbytes = 4 * n * rows + 6 * n * len(candidates)
    ops = n * rows + sum(c * c for c in candidates)
    return nbytes, ops


def phase_nms(torch, np, card):
    """Greedy NMS at the fused flush's shape (F = 32, N = 256): the NMS
    kernel alone against the plain loop on K4a's matrix, and ``ops.nms_mask``
    (K4a, then the NMS kernel) beside the old route (K4a, then the plain
    loop) in turns; then every case of ``testing.nms_corner_cases`` on the
    card.  Returns the kernel's row."""
    from repro_torch.kernels import iou_matrix as im
    from repro_torch.kernels import nms as nm
    from repro_torch.kernels import ops, ref
    from repro_torch.testing import nms_corner_cases, rand_boxes
    f, n = 32, 256
    rng = np.random.default_rng(SEED + 3)
    boxes = torch.as_tensor(rand_boxes(rng, (f, n)), device="cuda")
    scores = torch.as_tensor(rng.random((f, n), dtype=np.float32),
                             device="cuda")
    valid = torch.as_tensor(rng.random((f, n)) > 0.5, device="cuda")
    iou = im.iou_matrix(boxes, boxes)
    got = nm.nms_greedy(iou, scores, valid)
    if not torch.equal(got, nm.nms_greedy_ref(iou, scores, valid)):
        raise AssertionError("the NMS kernel differs from the plain loop")
    if not torch.equal(ops.nms_mask(boxes, scores, valid),
                       ref.nms_mask(boxes, scores, valid)):
        raise AssertionError("ops.nms_mask differs from the plain NMS")
    cands = nms_candidates(torch, scores, valid)
    timed = measure(torch, lambda: nm.nms_greedy(iou, scores, valid),
                    once=True)
    plain = measure(torch, lambda: nm.nms_greedy_ref(iou, scores, valid),
                    reps=5)
    row = _row("nms_greedy", "src/repro_torch/csrc/nms.cu", NMS_REPLACES,
               f"F={f} N={n}", 0.0, timed, plain, None,
               *nms_bound(n, cands))
    row["candidates"] = sum(cands)
    _report(f"NMS nms_greedy F={f} N={n} ({sum(cands)} candidates, "
            f"{max(cands)} in the longest frame, {int(got.sum())} kept; the "
            f"bound prices the rows at HBM's rate, the run reads them from "
            f"L2): masks equal", row, card)
    # the new route against the old one, in turns (new, old, old, new)
    routes = {"new": lambda: ops.nms_mask(boxes, scores, valid),
              "old": lambda: ref.nms_greedy(im.iou_matrix(boxes, boxes),
                                            scores, valid)}
    turns = in_turns(routes, lambda fn: time_ms(torch, fn, reps=10,
                                                warmup=2))
    dev = {"new": profile_device(torch, routes["new"], 10, once=True)[0],
           "old": profile_device(torch, routes["old"])[0]}
    row["route_ms"] = {k: statistics.mean(v) for k, v in turns.items()}
    row["route_turns_ms"] = turns
    row["route_device_ms"] = dev
    print(f"ops.nms_mask F={f} N={n} in turns (new, old, old, new): new "
          f"route (K4a + NMS kernel) {turns['new'][0]:.4f}, "
          f"{turns['new'][1]:.4f} ms per call ({fmt(dev['new'])} on the "
          f"device); old route (K4a + plain loop of {n} steps) "
          f"{turns['old'][0]:.3f}, {turns['old'][1]:.3f} ms per call "
          f"({fmt(dev['old'])} on the device); masks equal [{card}]")
    cases = nms_corner_cases()
    for name, (b, s_, v, thr) in cases.items():
        args = [torch.as_tensor(a, device="cuda") for a in (b, s_, v)]
        if not torch.equal(ops.nms_mask(*args, thr),
                           ref.nms_mask(*args, thr)):
            raise AssertionError(f"NMS corner case {name} differs from the "
                                 "plain NMS")
    row["ptxas"] = kernel_ptxas("nms_greedy_kernel")
    print(f"NMS: {len(cases)} corner cases (ties, -0.0, NaN scores and "
          f"coordinates, -1e30 / -inf, an IoU at the threshold and one ulp "
          f"either side, N = 1, 37, 256) masks equal; ptxas: "
          + "; ".join(row["ptxas"]) + f" [{card}]")
    return row


def phase_nms_served(torch, card, served, row):
    """``ops.nms_mask`` on the operands of the main path's last NMS call
    (the last fused flush's proposal NMS) against the plain NMS, and the
    kernel timed on them; the numbers go into the NMS row as
    ``served``."""
    from repro_torch.kernels import iou_matrix as im
    from repro_torch.kernels import nms as nm
    from repro_torch.kernels import ops, ref
    (boxes, scores, valid), kw = served
    got = ops.nms_mask(boxes, scores, valid, **kw)
    if not torch.equal(got, ref.nms_mask(boxes, scores, valid, **kw)):
        raise AssertionError("NMS on the main path's operands differs from "
                             "the plain NMS")
    f, n = scores.shape
    iou = im.iou_matrix(boxes, boxes)
    cands = nms_candidates(torch, scores, valid)
    timed = measure(torch, lambda: nm.nms_greedy(iou, scores, valid, **kw),
                    once=True)
    plain = measure(torch, lambda: nm.nms_greedy_ref(iou, scores, valid,
                                                     **kw), reps=5)
    served_row = _row("nms_greedy", "", "", f"F={f} N={n}", 0.0, timed,
                      plain, None, *nms_bound(n, cands))
    _report(f"NMS nms_greedy served F={f} N={n} (the last fused flush's "
            f"proposal NMS: {sum(cands)} candidates, {int(got.sum())} "
            f"kept): masks equal", served_row, card)
    row["served"] = {k: served_row[k] for k in (
        "shape", "ms", "device_ms", "plain_ms", "plain_device_ms",
        "bound_ms", "bound_by")}
    row["served"]["candidates"] = sum(cands)


# ---------------------------------------------------------------------------
# the serving path at full width
# ---------------------------------------------------------------------------
def compare_results(np, a, b, what: str, scores_atol: float) -> int:
    """Equal valid/labels/source except where the fog decision's float lies
    within THRESHOLD_TIE of its threshold (the count is returned); finite,
    allclose scores and boxes; equal proposal masks."""
    from repro_torch.testing import THRESHOLD_TIE
    for name in ("fog_scores", "fog_features", "boxes"):
        for r in (a, b):
            if not np.isfinite(getattr(r, name)).all():
                raise AssertionError(f"{what}: non-finite {name}")
    np.testing.assert_allclose(a.fog_scores, b.fog_scores, atol=scores_atol,
                               err_msg=what)
    np.testing.assert_allclose(a.boxes, b.boxes, atol=scores_atol,
                               err_msg=what)
    np.testing.assert_array_equal(a.prop_valid, b.prop_valid, err_msg=what)
    top2 = np.sort(a.fog_scores, -1)[..., -2:]
    near = lambda x: np.abs(x - 0.5) <= THRESHOLD_TIE        # noqa: E731
    tie = (near(a.fog_scores.max(-1)) | near(b.fog_scores.max(-1))
           | ((top2[..., 1] - top2[..., 0]) <= THRESHOLD_TIE)) & a.prop_valid
    for name in ("valid", "labels", "source"):
        x, y = getattr(a, name), getattr(b, name)
        if (x != y)[~tie].any():
            raise AssertionError(f"{what}: {name} differs away from "
                                 "threshold ties")
    return int(tie.sum())


def make_streams(np, n_streams, n_chunks, n_frames):
    from repro_torch.video import synthetic
    return [[synthetic.make_chunk(np.random.default_rng(50 + i), "traffic",
                                  num_frames=n_frames)
             for _ in range(n_chunks)] for i in range(n_streams)]


def run_path(torch, np, hot_path, params, streams, device="cuda"):
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro_torch.core.coordinator import MultiStreamCoordinator
    from repro_torch.core.protocol import HighLowProtocol
    from repro_torch.kernels import ops
    det_params, clf_params = params
    multi = MultiStreamCoordinator(
        HighLowProtocol(DETECTOR, CLASSIFIER, device=device), det_params,
        clf_params, streams, max_batch_chunks=len(streams),
        batch_window=0.05, hot_path=hot_path, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = multi.run(learn=False)
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    # materialize every result array (off the clock)
    results = {name: [res for _, res, _ in st.results]
               for name, st in multi.scheduler.streams.items()}
    return multi, out, results, counts, wall


def video_params(torch, device):
    """The full-width vpaas_video models, random from seeds SEED and
    SEED + 1 (drawn on the CPU, so every device gets the same weights)."""
    from repro_torch import weights
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    return (weights.init_detector(
                DETECTOR, torch.Generator().manual_seed(SEED), device),
            weights.init_classifier(
                CLASSIFIER, torch.Generator().manual_seed(SEED + 1), device))


def phase_main_path(torch, np, card):
    from repro_torch.configs.vpaas_video import CLASSIFIER
    n_streams, n_chunks, n_frames = 8, 4, 4
    params = video_params(torch, "cuda")
    # warm-up (cuDNN algorithm selection, allocator) on a one-chunk workload
    warm = make_streams(np, n_streams, 1, n_frames)
    for hot_path in ("fused", "sync"):
        run_path(torch, np, hot_path, params, warm)
    streams = make_streams(np, n_streams, n_chunks, n_frames)
    runs = {}
    from repro_torch.kernels import ops
    for hot_path in ("fused", "sync"):
        # the fused run keeps its last flush's K1 and NMS operands
        with LastCall(ops, "region_filter_mask_batch") as k1_call, \
                LastCall(ops, "nms_mask") as nms_call:
            multi, out, results, counts, wall = run_path(
                torch, np, hot_path, params, streams)
        if hot_path == "fused":
            served = k1_call.args, nms_call.args
        frames = n_streams * n_chunks * n_frames
        hps = multi.scheduler.hot_path_stats
        print(f"main path ({hot_path}): {n_streams} streams x {n_chunks} "
              f"chunks x {n_frames} frames, full vpaas_video width: "
              f"{wall:.3f} s wall, {frames / wall:.1f} frames/s, "
              f"{hps['flushes']} flushes, {hps['host_syncs']} host syncs, "
              f"launches {counts} [{card}]")
        runs[hot_path] = (multi, out, results, counts, wall)
    fused_counts, sync_counts = runs["fused"][3], runs["sync"][3]
    for name in VIDEO_KERNELS:
        if fused_counts[name] == 0:
            raise AssertionError(f"fused path launched no {name} kernel")
    for name in ("region_filter_mask_batch", "onevsall_scores", "iou_matrix",
                 "nms_greedy"):
        if sync_counts[name] == 0:
            raise AssertionError(f"sync path launched no {name} kernel")
    for counts in (fused_counts, sync_counts):
        check_nms_launches(counts, "main path")
    hps = runs["fused"][0].scheduler.hot_path_stats
    if hps["host_syncs"] != hps["flushes"]:
        raise AssertionError(f"fused path: {hps['host_syncs']} host syncs "
                             f"for {hps['flushes']} flushes")
    ties = 0
    for name, res_f in runs["fused"][2].items():
        res_s = runs["sync"][2][name]
        for i, (a, b) in enumerate(zip(res_f, res_s)):
            if a.fog_scores.shape != (n_frames, 256, CLASSIFIER.num_classes):
                raise AssertionError(f"unexpected fog_scores shape "
                                     f"{a.fog_scores.shape}")
            ties += compare_results(np, a, b, f"fused vs sync {name}[{i}]",
                                    1e-5)
        if runs["fused"][1][name].f1 != runs["sync"][1][name].f1:
            ties_note = " (threshold ties present)" if ties else ""
            if not ties:
                raise AssertionError(f"{name}: F1 differs between paths")
            print(f"note: {name} F1 differs between paths{ties_note}")
    print(f"fused vs sync: valid/labels/source equal, scores within 1e-5 "
          f"({ties} proposal(s) exempt as threshold ties) [{card}]")
    profile_main_path(torch, np, card, params, streams)
    return fused_counts, sync_counts, runs, served


def check_nms_launches(counts, what: str):
    """Every ``ops.nms_mask`` on the card is one K4a and one NMS kernel
    launch: the two counts are equal on every path."""
    if counts["nms_greedy"] != counts["iou_matrix"]:
        raise AssertionError(f"{what}: {counts['iou_matrix']} K4a launches "
                             f"but {counts['nms_greedy']} NMS launches")


def profile_main_path(torch, np, card, params, streams):
    """Where the fused path's time goes: one more run under torch.profiler
    (its wall time is inflated by the tracing; the shares are what count)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run_path(torch, np, "fused", params, streams)[-1]
    avgs = prof.key_averages()
    busy_ms = sum(_self_device_us(e) for e in avgs) / 1e3
    launches = sum(e.count for e in avgs if _self_device_us(e) > 0)
    print(f"fused path under the profiler: {wall * 1e3:.1f} ms wall, device "
          f"busy {busy_ms:.1f} ms ({busy_ms / (wall * 1e3):.1%}), "
          f"{launches} device kernels/copies [{card}]")
    by_dev = sorted(avgs, key=_self_device_us, reverse=True)[:8]
    print("  top device time: " + "; ".join(
        f"{e.key[:48]} {_self_device_us(e) / 1e3:.2f} ms x{e.count}"
        for e in by_dev))
    by_cpu = sorted(avgs, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]
    print("  top host time: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
        for e in by_cpu))


def phase_reference(torch, np, card):
    """Each full-width stage on the card against the port's CPU path (the
    kernels' plain versions) on one 4-frame chunk, same weights.  Every
    stage gets the card's output of the stage before it, so float
    differences of one stage cannot flip the next stage's thresholds."""
    from repro_torch import weights
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro_torch.core import protocol as pm
    from repro_torch.core.regions import RegionSplit
    pcfg = pm.ProtocolConfig()
    chunk = make_streams(np, 1, 1, 4)[0][0]
    cpu = lambda v: v.cpu()                                     # noqa: E731
    det_p = {d: weights.init_detector(
        DETECTOR, torch.Generator().manual_seed(SEED), d)
        for d in ("cuda", "cpu")}
    clf_p = {d: weights.init_classifier(
        CLASSIFIER, torch.Generator().manual_seed(SEED + 1), d)
        for d in ("cuda", "cpu")}
    hq = torch.as_tensor(chunk.frames, device="cuda")
    enc = pm.encode_low(pcfg, hq)
    enc_c = pm.encode_low(pcfg, cpu(hq))
    np.testing.assert_allclose(enc.frames.cpu().numpy(),
                               enc_c.frames.numpy(), atol=1e-5)
    rel = abs(float(enc.nbytes) - float(enc_c.nbytes)) / float(enc_c.nbytes)
    if rel > 1e-4:
        raise AssertionError(f"encode nbytes differ by {rel:.2e} (rel)")
    det = pm.detect_regions(DETECTOR, det_p["cuda"], enc.frames)
    det_c = pm.detect_regions(DETECTOR, det_p["cpu"], cpu(enc.frames))
    for k in det:
        np.testing.assert_allclose(det[k].cpu().numpy(), det_c[k].numpy(),
                                   atol=1e-4, err_msg=k)
    split, _ = pm.split_uncertain(pcfg, det)
    split_c, _ = pm.split_uncertain(pcfg, {k: cpu(v) for k, v in det.items()})
    for k in ("acc_valid", "prop_valid", "acc_labels"):
        if not torch.equal(getattr(split, k).cpu(), getattr(split_c, k)):
            raise AssertionError(f"split {k}: card differs from CPU")
    merged = pm.classify_regions(CLASSIFIER, pcfg, clf_p["cuda"],
                                 clf_p["cuda"]["W"], hq, split)
    merged_c = pm.classify_regions(CLASSIFIER, pcfg, clf_p["cpu"],
                                   clf_p["cpu"]["W"], cpu(hq),
                                   RegionSplit(*map(cpu, split)))
    kw = dict(wan_bytes=0.0, coord_bytes=0.0, cloud_frames=4, latency=None)
    ties = compare_results(np, pm.assemble_result(split, merged, **kw),
                           pm.assemble_result(split_c, merged_c, **kw),
                           "card vs CPU classify", 1e-4)
    print(f"card vs CPU reference, one full-width chunk: encode within "
          f"1e-5 (bytes rel {rel:.1e}), detector within 1e-4, split masks "
          f"equal, classify scores within 1e-4 ({ties} tie(s)) [{card}]")


# ---------------------------------------------------------------------------
# the paper's comparison baselines (§VI, Fig. 9) beside VPaaS, through the
# policy manager: every policy's NMS runs K4a, DDS's round 1 runs K4b
# ---------------------------------------------------------------------------
BASE_CHUNKS, BASE_FRAMES = 2, 8
REF_CHUNKS, REF_FRAMES = 2, 4         # the card vs CPU reference
BASE_DATA_SEED = 2024                 # bench_protocol's dataset seed
# MPEG first: the other policies' bytes are normalised to it
POLICIES = ("mpeg", "glimpse", "cloudseg", "dds", "vpaas-highlow")


def baseline_workload(n_chunks, n_frames):
    """bench_protocol's workload: ``n_chunks`` chunks of each content type."""
    from repro_torch.video import synthetic
    return {name: synthetic.dataset(BASE_DATA_SEED + i, name, n_chunks,
                                    num_frames=n_frames)
            for i, name in enumerate(synthetic.CONTENT_TYPES)}


def run_policy(torch, name, system, params, chunks):
    """One policy over ``chunks``, as a user calls it; launch counts zeroed
    just before and read just after."""
    from repro_torch.kernels import ops
    det_params, clf_params = params
    cuda = system.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if name == "vpaas-highlow":
        results = [system.process_chunk(det_params, clf_params, c.frames)
                   for c in chunks]
    else:
        results = [system.process_chunk(det_params, c.frames)
                   for c in chunks]
    if cuda:
        torch.cuda.synchronize()
    return results, ops.launch_counts(), time.perf_counter() - t0


def phase_baselines_main_path(torch, np, card, params=None):
    """The five policies on BASE_CHUNKS x BASE_FRAMES of each content type;
    ``params`` are trained (detector, classifier) weights, or None for the
    random ones.  Returns the launch counts per policy."""
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro_torch.core.protocol import detections_for_metrics
    from repro_torch.serving.policies import default_policies
    from repro_torch.video.metrics import F1Accumulator
    trained = params is not None
    params = params if trained else video_params(torch, "cuda")
    pm = default_policies()
    systems = {name: pm.build(name, DETECTOR, CLASSIFIER, device="cuda")
               for name in POLICIES}
    data = baseline_workload(BASE_CHUNKS, BASE_FRAMES)
    # warm-up (cuDNN algorithm selection at each policy's shapes)
    for name, system in systems.items():
        run_policy(torch, name, system, params, data["traffic"][:1])
    totals = {name: {} for name in POLICIES}
    print(f"baselines main path: {BASE_CHUNKS} chunks x {BASE_FRAMES} frames"
          f" of each content type, full vpaas_video width, the five "
          f"policies of default_policies(); "
          + ("trained weights (F1 against the synthetic ground truth: "
             "Fig. 9's accuracy axis)" if trained else
             "F1 against the synthetic ground truth is meaningless with "
             "random weights") + f" [{card}]")
    for content, chunks in data.items():
        mpeg_bytes = None
        for name in POLICIES:
            results, counts, wall = run_policy(torch, name, systems[name],
                                               params, chunks)
            frames = sum(c.frames.shape[0] for c in chunks)
            acc = F1Accumulator()
            for res, c in zip(results, chunks):
                if res.boxes.shape != (c.frames.shape[0], 256, 4) or not (
                        np.isfinite(res.boxes).all()
                        and res.latency.total > 0 and res.wan_bytes > 0):
                    raise AssertionError(f"{name} on {content}: malformed "
                                         "result")
                for t in range(c.frames.shape[0]):
                    boxes, labels = (detections_for_metrics(res, t)
                                     if name == "vpaas-highlow"
                                     else res.detections(t))
                    acc.update(boxes, labels, c.gt_boxes[t],
                               c.gt_labels[t])
            nbytes = sum(r.wan_bytes for r in results)
            mpeg_bytes = mpeg_bytes or nbytes
            rounds = (float(np.mean([r.cloud_rounds for r in results]))
                      if name != "vpaas-highlow" else 1.0)
            print(f"  {content}/{name}: {wall:.3f} s wall, "
                  f"{frames / wall:.1f} frames/s, WAN {nbytes:.0f} B "
                  f"({nbytes / mpeg_bytes:.3f} of MPEG), cloud frames "
                  f"{sum(r.cloud_frames for r in results)}, rounds "
                  f"{rounds:.3f}, F1 {acc.f1:.3f}; launches "
                  f"{ {k: v for k, v in counts.items() if v} } [{card}]")
            if counts["iou_matrix"] == 0:
                raise AssertionError(f"{name} launched no K4a")
            check_nms_launches(counts, f"{content}/{name}")
            if name == "dds":
                if counts["region_filter_mask"] != frames:
                    raise AssertionError(
                        f"DDS launched K4b {counts['region_filter_mask']} "
                        f"times for {frames} frames")
                if counts["region_filter_mask_batch"]:
                    raise AssertionError("DDS launched K1")
            elif counts["region_filter_mask"]:
                raise AssertionError(f"{name} launched K4b")
            if name == "vpaas-highlow":
                for k in VIDEO_KERNELS:
                    if counts[k] == 0:
                        raise AssertionError(f"VPaaS launched no {k}")
            for k, v in counts.items():
                totals[name][k] = totals[name].get(k, 0) + v
    return totals


def phase_baselines_reference(torch, np, card):
    """The four baselines at REF_CHUNKS chunks x REF_FRAMES frames per
    content type, full width, the same weights, on the card and on the
    port's CPU path: equal valid / labels away from threshold ties, boxes
    within MODEL_ATOL,
    equal cloud frames and rounds, bytes and latencies within their
    tolerances.  The CPU run takes the card's decoded frames
    (``testing.CodecTap``) so that a half-step tie in the codec cannot
    move the detector; the tap checks any codec difference is a tie."""
    from repro_torch.configs.vpaas_video import DETECTOR
    from repro_torch.serving.policies import default_policies
    from repro_torch.testing import (CodecTap, DetectorTies,
                                     assert_baseline_results_match)
    params = {d: video_params(torch, d) for d in ("cuda", "cpu")}
    pm = default_policies()
    compared = flips = exempt_n = 0
    launches = {}
    for name in ("mpeg", "glimpse", "cloudseg", "dds"):
        card_sys = pm.build(name, DETECTOR, device="cuda")
        cpu_sys = pm.build(name, DETECTOR, device="cpu")
        for content, chunks in baseline_workload(REF_CHUNKS,
                                                 REF_FRAMES).items():
            for chunk in chunks:
                with CodecTap() as rec:
                    (want,), counts, _ = run_policy(
                        torch, name, card_sys, params["cuda"], [chunk])
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                with CodecTap(lambda kind, f, r, q, i: rec.frames[i]) as tap, \
                        DetectorTies(cpu_sys.theta_loc,
                                     cpu_sys.theta_cls) as ties:
                    (got,), _, _ = run_policy(torch, name, cpu_sys,
                                              params["cpu"], [chunk])
                flips += tap.tie_flips()
                exempt = ties.exempt(got.valid.shape)
                exempt_n += int(exempt.sum())
                assert_baseline_results_match(got, want, exempt,
                                              f"card vs CPU {name} {content}")
                compared += 1
    if launches["iou_matrix"] == 0 or launches["region_filter_mask"] == 0:
        raise AssertionError(f"baselines reference launches {launches}")
    check_nms_launches(launches, "baselines reference")
    print(f"baselines card vs CPU reference, MPEG / Glimpse / CloudSeg / DDS "
          f"x {REF_CHUNKS} chunks x {REF_FRAMES} frames of each content type "
          f"at full width: "
          f"{compared} chunk results equal (valid, labels, cloud frames and "
          f"rounds; boxes within MODEL_ATOL, bytes and latencies within "
          f"their tolerances; {exempt_n} tie position(s) exempt, {flips} "
          f"codec call(s) with a half-step tie); card launches K4a "
          f"{launches['iou_matrix']}, NMS {launches['nms_greedy']}, K4b "
          f"{launches['region_filter_mask']} [{card}]")


# ---------------------------------------------------------------------------
# the continual-learning path: the plane (per-site, Eq. 9 ensemble serving)
# and the inline learner on the full-width video path; K5 in the trainer
# ---------------------------------------------------------------------------
LEARN_STREAMS, LEARN_CHUNKS, LEARN_FRAMES = 8, 4, 4
# the episode's detector thresholds (LearningConfig.adapt_theta_*): a
# stricter direct-acceptance bar and a lower location bar route more of
# cam0's regions to the fog classifier, where the episode harvests its
# labels; with them set, every flush holding cam0 takes the dynamic split
# through K1
ADAPT_THETA = dict(adapt_theta_cls=0.9, adapt_theta_loc=0.4)


def learning_workload(n_streams, n_chunks, n_frames):
    """The drifted streams and the LearningConfig of ``serve --learning
    --per-site-learning --ensemble-serving`` (camera 0 drifts in its second
    half), plus the episode thresholds.  The drift detector's warm-up is
    raised to the run's chunk count: with random weights its statistic
    (sentinel-verified accuracy) is noise, so cam0's episode is opened by
    hand (``testing.open_episode``) and no noise event may open another."""
    import argparse
    import dataclasses

    from repro_torch.launch import serve
    args = argparse.Namespace(
        video_streams=n_streams, video_chunks=n_chunks,
        video_frames=n_frames, learning=True, per_site_learning=True,
        ensemble_serving=True, label_budget=256, drift_window=8)
    base = serve.learning_config(args)
    cfg = dataclasses.replace(
        base, drift=dataclasses.replace(base.drift, warmup=n_chunks),
        **ADAPT_THETA)
    return serve.drifted_streams(args), cfg


class RoundTimer:
    """Wall time of each background training round: wraps
    ``BackgroundTrainer.maybe_train`` with a synchronise before and after,
    keeping only the calls that trained."""

    def __init__(self, torch):
        from repro_torch.learning import trainer
        self.torch, self.cls, self.times = torch, trainer.BackgroundTrainer, []
        self.orig = self.cls.maybe_train

    def __enter__(self):
        orig, times, torch = self.orig, self.times, self.torch

        def timed(trainer, *args, **kw):
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = orig(trainer, *args, **kw)
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
            if rec is not None:
                times.append(time.perf_counter() - t0)
            return rec

        self.cls.maybe_train = timed
        return self

    def __exit__(self, *exc):
        self.cls.maybe_train = self.orig
        return False


def run_learning(torch, device, params, streams, cfg, *, inline=False,
                 forced=True):
    """One run of the continual-learning plane with cam0's episode opened
    by hand (or, with ``inline``, of per-stream IncrementalLearners and no
    plane) on ``device``; launch counts zeroed just before the run, read
    just after (K5's replays and steps beside them, as ``onevsall_replay``
    and ``onevsall_steps``).  ``forced=False`` leaves the episodes to the
    drift detector, as ``serve`` does."""
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro_torch.core.coordinator import (MultiStreamCoordinator,
                                              StreamSpec)
    from repro_torch.core.hitl import OracleAnnotator
    from repro_torch.core.incremental import IncrementalLearner
    from repro_torch.core.protocol import HighLowProtocol
    from repro_torch.kernels import onevsall_update as ou
    from repro_torch.kernels import ops
    from repro_torch.learning import ContinualLearningPlane
    from repro_torch.testing import open_episode
    plane = None
    if inline:
        streams = [StreamSpec(name=f"cam{i}", chunks=chunks,
                              learner=IncrementalLearner(
                                  num_classes=CLASSIFIER.num_classes,
                                  rule="proximal"),
                              annotator=OracleAnnotator(iou_threshold=0.0))
                   for i, chunks in enumerate(streams)]
    else:
        plane = ContinualLearningPlane(
            CLASSIFIER.num_classes, cfg,
            annotator=OracleAnnotator(iou_threshold=0.0,
                                      budget=cfg.label_budget))
    multi = MultiStreamCoordinator(
        HighLowProtocol(DETECTOR, CLASSIFIER, device=device), *params,
        streams, max_batch_chunks=len(streams), batch_window=0.05,
        learning_plane=plane, device=device)
    if plane is not None and forced:
        open_episode(plane, multi.scheduler, "cam0")
    W0 = {name: st.W.copy() for name, st in multi.scheduler.streams.items()}
    if device == "cuda":
        torch.cuda.synchronize()
    with RoundTimer(torch) as rounds:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        multi.run(learn=True)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        counts.update(onevsall_replay=ou.replays, onevsall_steps=ou.steps)
    return plane, multi, counts, wall, W0, rounds.times


def phase_learning_main_path(torch, np, card):
    from repro_torch.launch.serve import print_learning_summary
    from repro_torch.testing import replayed_instances
    streams, cfg = learning_workload(LEARN_STREAMS, LEARN_CHUNKS,
                                     LEARN_FRAMES)
    params = video_params(torch, "cuda")
    plane, multi, counts, wall, W0, rounds = run_learning(
        torch, "cuda", params, streams, cfg)
    sched = multi.scheduler
    zoo = sched.graph.zoo
    s = plane.summary()
    replayed = replayed_instances(zoo, "fog-classifier[cam0]")
    steps = cfg.passes * replayed
    n_rounds = sum(site["trainer"]["rounds"] for site in s["sites"].values())
    print(f"learning main path: {LEARN_STREAMS} streams x {LEARN_CHUNKS} "
          f"chunks x {LEARN_FRAMES} frames of drifted traffic, full "
          f"vpaas_video width, per-site plane with Eq. 9 ensemble serving, "
          f"cam0's episode opened by hand: {wall:.3f} s wall, "
          f"{sched.hot_path_stats['flushes']} flushes, "
          f"{sched.hot_path_stats['host_syncs']} host syncs; launches K1 "
          f"{counts['region_filter_mask_batch']}, K4a {counts['iou_matrix']}, "
          f"NMS {counts['nms_greedy']}, K3 "
          f"{counts['onevsall_scores']}, K5 {counts['onevsall_update']} "
          f"(= {n_rounds} training rounds, {counts['onevsall_replay']} of "
          f"them replays) running {counts['onevsall_steps']} steps (= "
          f"{cfg.passes} passes x {replayed} replayed) [{card}]")
    print_learning_summary(s)
    print("  trainer wall per round: " + (", ".join(
        f"{t * 1e3:.2f} ms" for t in rounds) or "no round") + f" [{card}]")
    if not (counts["onevsall_update"] == counts["onevsall_replay"]
            == n_rounds > 0 and counts["onevsall_steps"] == steps > 0):
        raise AssertionError(f"K5 launched {counts['onevsall_update']} "
                             f"times ({counts['onevsall_replay']} replays) "
                             f"for {n_rounds} rounds and ran "
                             f"{counts['onevsall_steps']} steps; cam0's "
                             f"rounds replayed {replayed} instances x "
                             f"{cfg.passes} passes")
    for name in VIDEO_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"learning path launched no {name} kernel")
    check_nms_launches(counts, "learning path")
    for name, st in sched.streams.items():
        if name == "cam0":
            continue
        if not np.array_equal(st.W, W0[name]) or st.ensemble is not None:
            raise AssertionError(f"{name}'s readout changed outside cam0's "
                                 "episode")
        if zoo.versions(f"fog-classifier[{name}]") != [1]:
            raise AssertionError(f"{name}'s lineage grew: "
                                 f"{zoo.versions(f'fog-classifier[{name}]')}")
    if s["labels_charged"] > cfg.label_budget:
        raise AssertionError(f"{s['labels_charged']} labels charged over a "
                             f"budget of {cfg.label_budget}")
    if s["hot_swaps"] < 1 or sched.monitor.counters.get("hot_swaps", 0) < 1:
        raise AssertionError("the learning run made no hot swap")
    # the plane reads the hand-off fields from the flush bundles, which the
    # scheduler counts as downloads, not blocking reads: host_syncs stays
    # one per flush, as the JAX package shows on the same scenario
    # (tests/test_torch_learning.py compares the two)
    hps = sched.hot_path_stats
    if hps["host_syncs"] != hps["flushes"]:
        raise AssertionError(f"learning path: {hps['host_syncs']} host syncs "
                             f"for {hps['flushes']} flushes")

    # the same scenario with the inline learner and no plane
    _, imulti, icounts, iwall, _, irounds = run_learning(
        torch, "cuda", params, streams, cfg, inline=True)
    learners = [st.learner for st in imulti.scheduler.streams.values()]
    consumed = sum(ln.labels_used - ln.buffered for ln in learners)
    passes = learners[0].passes
    updates = sum(ln.updates_done for ln in learners)
    print(f"inline learner (StreamSpec.learner, no plane), same workload: "
          f"{iwall:.3f} s wall, {updates} updates over {consumed} "
          f"instances; K5 launches {icounts['onevsall_update']} (= "
          f"{updates} updates) running {icounts['onevsall_steps']} steps "
          f"(= {passes} passes x {consumed}) [{card}]")
    if not (icounts["onevsall_update"] == icounts["onevsall_replay"]
            == updates > 0
            and icounts["onevsall_steps"] == passes * consumed > 0):
        raise AssertionError(f"inline learner: K5 launched "
                             f"{icounts['onevsall_update']} times and ran "
                             f"{icounts['onevsall_steps']} steps for "
                             f"{updates} updates of {consumed} instances x "
                             f"{passes} passes")
    counts.update(inline_launches=icounts["onevsall_update"],
                  inline_steps=icounts["onevsall_steps"])
    return counts


def phase_learning_reference(torch, np, card):
    """The same forced-adapt scenario at a small size (2 streams x 2 chunks
    x 2 frames, full-width models, the same weights) on the card and on the
    port's CPU path: equal discrete outcomes, cam0's W within LEARN_RTOL."""
    from repro_torch.testing import LEARN_RTOL, rel_err, replayed_instances
    streams, cfg = learning_workload(2, 2, 2)
    runs = {d: run_learning(torch, d, video_params(torch, d), streams, cfg)
            for d in ("cuda", "cpu")}

    def outcome(run):
        plane, multi, counts, *_ = run
        s, zoo = plane.summary(), multi.scheduler.graph.zoo
        return {
            "labels_charged": s["labels_charged"],
            "rounds": {n: site["trainer"]["rounds"]
                       for n, site in s["sites"].items()},
            "versions": {n: zoo.versions(f"fog-classifier[{n}]")
                         for n in multi.scheduler.streams},
            "promotions": s["promotions"], "rollbacks": s["rollbacks"],
            "ensemble_promotions": s["ensemble_promotions"],
            "hot_swaps": s["hot_swaps"],
            "events": [e["event"] for e in multi.scheduler.monitor.events],
            "replayed": replayed_instances(zoo, "fog-classifier[cam0]")}

    card_out, cpu_out = outcome(runs["cuda"]), outcome(runs["cpu"])
    for key in card_out:
        if card_out[key] != cpu_out[key]:
            raise AssertionError(f"learning reference: {key} on the card "
                                 f"{card_out[key]} vs CPU {cpu_out[key]}")
    W = runs["cuda"][1].scheduler.streams["cam0"].W
    W_cpu = runs["cpu"][1].scheduler.streams["cam0"].W
    err = rel_err(W, W_cpu)
    if not (np.isfinite(W).all() and err <= LEARN_RTOL):
        raise AssertionError(f"cam0's W: card vs CPU {err:.2e} of its scale "
                             f"(tolerance {LEARN_RTOL})")
    k5 = runs["cuda"][2]
    print(f"learning card vs CPU reference, 2 streams x 2 chunks x 2 frames "
          f"at full width: labels {card_out['labels_charged']}, rounds "
          f"{card_out['rounds']}, promotions {card_out['promotions']}, "
          f"rollbacks {card_out['rollbacks']}, hot swaps "
          f"{card_out['hot_swaps']}, zoo versions and event kinds equal; "
          f"K5 on the card {k5['onevsall_update']} launches, "
          f"{k5['onevsall_steps']} steps; cam0's W within {err:.2e} of its "
          f"scale (tolerance {LEARN_RTOL}) [{card}]")


# ---------------------------------------------------------------------------
# video-model training at full width (repro_torch.training), then the video
# path, the five policies and the learning plane on the trained weights
# ---------------------------------------------------------------------------
TRAIN_SEED = 5
# tests/test_system.py's module fixture: (model, config, steps, batch size,
# degrade; None for the classifier, whose loop takes no such argument)
TRAIN_RUNS = (("detector", "DETECTOR", 200, 16, True),
              ("classifier", "CLASSIFIER", 200, 64, None),
              ("fallback", "FALLBACK_DETECTOR", 80, 8, False))
TRAIN_PROFILE_STEPS = 4
TRAIN_REF_STEPS = 3
TRAINED_DIR = os.path.join(ROOT, "build", "trained")


def step_split(wall_s: float, host_s, device_ms) -> dict:
    """Milliseconds per step of a training run: its wall, the host's batch
    generation (``host_s``, one per step), the device step from its start
    to the end of its last kernel (CUDA events, ``device_ms``), and the rest
    (the batch's copy to the card, the codec on degraded batches, the
    loop); and the host generation's share of the wall."""
    n = len(device_ms)
    if n == 0 or len(host_s) != n:
        raise AssertionError(f"{len(host_s)} batches for {n} steps")
    wall, host = wall_s * 1e3 / n, sum(host_s) * 1e3 / n
    dev = sum(device_ms) / n
    return {"steps": n, "wall_ms": wall, "host_ms": host, "device_ms": dev,
            "other_ms": wall - host - dev, "host_share": host / wall}


class StepSplit:
    """Time each training step's parts: the host clock around each batch
    the loops draw from ``training.data`` and CUDA events around each call
    of ``train_loop.detector_step`` / ``classifier_step`` (both looked up by
    the loops at call time, so wrapping the module attributes reaches
    them)."""

    def __init__(self, torch):
        from repro_torch.training import data, train_loop
        self.torch, self.host_s, self.events = torch, [], []
        self.targets = [(data, "detector_batches"),
                        (data, "classifier_batches"),
                        (train_loop, "detector_step"),
                        (train_loop, "classifier_step")]

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]
        for mod, name, fn in self.saved:
            wrap = self._batches if name.endswith("batches") else self._step
            setattr(mod, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    def _batches(self, fn):
        def batches(*args, **kw):
            it = fn(*args, **kw)
            while True:
                t0 = time.perf_counter()
                batch = next(it)
                self.host_s.append(time.perf_counter() - t0)
                yield batch
        return batches

    def _step(self, fn):
        torch = self.torch

        def step(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        return step

    def device_ms(self):
        self.torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in self.events]


def phase_training(torch, np, card):
    """The three video models trained on the card at full width with
    tests/test_system.py's step counts, through ``train_detector`` /
    ``train_classifier``: the loss must fall; the weights go through
    ``checkpoint.save`` / ``restore`` under ``build/trained`` bit for bit.
    Returns the restored weights by model."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import weights
    from repro_torch.configs import vpaas_video
    from repro_torch.training import checkpoint, train_loop
    trained = {}
    for name, cfg_name, steps, batch, degrade in TRAIN_RUNS:
        cfg = getattr(vpaas_video, cfg_name)
        kw = dict(batch_size=batch, seed=TRAIN_SEED, device="cuda")
        if degrade is None:
            train = train_loop.train_classifier
        else:
            train, kw["degrade"] = train_loop.train_detector, degrade
        # warm-up: cuDNN's algorithm choice at these shapes, the allocator
        train(cfg, steps=2, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with StepSplit(torch) as split:
            t0 = time.perf_counter()
            params, hist = train(cfg, steps=steps, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            parts = step_split(wall, split.host_s, split.device_ms())
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train(cfg, steps=TRAIN_PROFILE_STEPS, **kw)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        avgs = prof.key_averages()
        busy_ms = sum(_self_device_us(e) for e in avgs) / 1e3
        kernels = sum(e.count for e in avgs if _self_device_us(e) > 0)
        first, last = hist[0]["loss"], hist[-1]["loss"]
        print(f"training {name} ({cfg.name}, full width): {steps} steps at "
              f"batch {batch}, seed {TRAIN_SEED}"
              + ("" if degrade is None else f", degrade={degrade}")
              + f": {wall:.3f} s wall, {parts['wall_ms']:.2f} ms a step = "
              f"host batch {parts['host_ms']:.2f} ({parts['host_share']:.1%})"
              f" + device step {parts['device_ms']:.3f} (CUDA events) + "
              f"other {parts['other_ms']:.2f}; loss {first:.4f} -> "
              f"{last:.4f}; peak {peak / 2**20:.1f} MiB; under the profiler "
              f"{TRAIN_PROFILE_STEPS} steps {pwall * 1e3:.1f} ms wall, device "
              f"busy {busy_ms:.2f} ms ({busy_ms / (pwall * 1e3):.2%}) in "
              f"{kernels / TRAIN_PROFILE_STEPS:.0f} device kernels/copies a "
              f"step [{card}]")
        if not (np.isfinite(last) and last < first):
            raise AssertionError(f"{name}: loss did not fall: {hist}")
        path = os.path.join(TRAINED_DIR, name)
        checkpoint.save(path, params, {"steps": steps, "seed": TRAIN_SEED})
        back = checkpoint.restore(path, params)
        want, got = weights._flatten(params), weights._flatten(back)
        if want.keys() != got.keys() or not all(
                np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"{name}: checkpoint round trip not "
                                 "bit-equal")
        trained[name] = back
    print(f"trained weights saved and restored bit-equal under "
          f"{os.path.relpath(TRAINED_DIR, ROOT)} [{card}]")
    return trained


def phase_training_reference(torch, np, card):
    """TRAIN_REF_STEPS steps of each model's step function at full width
    from the same initial weights and batches on the card (twice) and on
    the port's CPU path: card runs bit-identical, card vs CPU within
    TRAIN_RTOL (``testing.assert_train_runs_match``)."""
    from repro_torch.testing import (TRAIN_RTOL, assert_train_runs_match,
                                     train_run, train_runs_identical)
    for name in ("detector", "fallback", "classifier"):
        runs = [train_run(name, d, TRAIN_REF_STEPS, TRAIN_SEED)
                for d in ("cuda", "cuda", "cpu")]
        if not train_runs_identical(runs[0], runs[1]):
            raise AssertionError(f"{name}: two card runs differ")
        err = assert_train_runs_match(runs[0], runs[2], name)
        print(f"training card vs CPU reference, {name} at full width, "
              f"{TRAIN_REF_STEPS} steps: card runs bit-identical; losses "
              f"within {err['loss']:.2e}, first gradients within "
              f"{err['grads']:.2e}, parameters within {err['params']:.2e} "
              f"of their scale (TRAIN_RTOL {TRAIN_RTOL}; losses "
              + ", ".join(f"{x:.4f}" for x in runs[0][2]) + f") [{card}]")


def detector_tie_frames(torch, np, params, chunk, device):
    """(F,) frames of one chunk at whose re-encoded frames the detector has
    a location or class score within THRESHOLD_TIE of the protocol's
    thresholds: a tie there may move the split, and NMS after it, between
    two devices."""
    from repro_torch.configs.vpaas_video import DETECTOR
    from repro_torch.core import protocol as pm
    from repro_torch.models.detector import detect
    from repro_torch.testing import THRESHOLD_TIE
    pcfg = pm.ProtocolConfig()
    enc = pm.encode_low(pcfg, torch.as_tensor(chunk.frames, device=device))
    det = detect(DETECTOR, params, enc.frames)
    loc = det["loc_scores"].cpu().numpy()
    conf = det["cls_probs"].amax(-1).cpu().numpy()
    return ((np.abs(loc - pcfg.theta_loc) <= THRESHOLD_TIE)
            | (np.abs(conf - pcfg.theta_cls) <= THRESHOLD_TIE)).any(-1)


def phase_trained_video(torch, np, card, trained, random_f1):
    """The fused video path (8 streams x 4 chunks x 4 frames of traffic) on
    the trained weights: F1 per stream and the accepted and candidate
    regions per frame; F1 above the random weights' run; the same run on
    the port's CPU path (fed the card's decoded frames through
    ``testing.CodecTap``) equal away from ties: whole frames where the
    detector ties a threshold, and the fog decisions compare_results
    exempts."""
    import types

    from repro_torch.testing import CodecTap
    n_streams, n_chunks, n_frames = 8, 4, 4
    streams = make_streams(np, n_streams, n_chunks, n_frames)
    from repro_torch.training.optimizer import tree_map
    params = {"cuda": (trained["detector"], trained["classifier"])}
    params["cpu"] = tuple(tree_map(lambda t: t.cpu(), p)
                          for p in params["cuda"])
    with CodecTap() as rec:
        multi, out, results, counts, wall = run_path(
            torch, np, "fused", params["cuda"], streams)
    for name in VIDEO_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"trained fused path launched no {name}")
    check_nms_launches(counts, "trained fused path")
    with CodecTap(lambda kind, f, r, q, i: rec.frames[i]) as tap:
        _, out_cpu, results_cpu, _, wall_cpu = run_path(
            torch, np, "fused", params["cpu"], streams, device="cpu")
    flips = tap.tie_flips()
    acc, cand, tie_frames, fog_ties, f1_notes = [], [], 0, 0, []
    for i, (name, res) in enumerate(results.items()):
        stream_ties = 0
        for j, (a, b) in enumerate(zip(res, results_cpu[name])):
            acc += list((a.valid & (a.source == 0)).sum(-1))
            cand += list(a.prop_valid.sum(-1))
            keep = ~detector_tie_frames(torch, np, params["cuda"][0],
                                        streams[i][j], "cuda")
            tie_frames += int((~keep).sum())
            stream_ties += int((~keep).sum())
            cut = lambda r: types.SimpleNamespace(**{               # noqa
                k: getattr(r, k)[keep] for k in (
                    "boxes", "labels", "valid", "source", "fog_features",
                    "prop_valid", "fog_scores")})
            n = compare_results(np, cut(a), cut(b),
                                f"trained card vs CPU {name}[{j}]", 1e-4)
            fog_ties += n
            stream_ties += n
        if out[name].f1 != out_cpu[name].f1:
            if not stream_ties:
                raise AssertionError(f"{name}: trained F1 differs card vs "
                                     "CPU away from ties")
            f1_notes.append(name)
    f1 = {name: out[name].f1["f1"] for name in out}
    mean_f1 = float(np.mean(list(f1.values())))
    mean_random = float(np.mean(list(random_f1.values())))
    print(f"trained fused path: {n_streams} streams x {n_chunks} chunks x "
          f"{n_frames} frames of traffic, {wall:.3f} s wall (CPU "
          f"{wall_cpu:.3f} s); F1 per stream "
          + ", ".join(f"{k} {v:.3f}" for k, v in f1.items())
          + f" (mean {mean_f1:.3f}; random weights {mean_random:.3f}); "
          f"accepted per frame {np.mean(acc):.2f} (min {min(acc)}, max "
          f"{max(acc)}), candidates per frame {np.mean(cand):.2f} (min "
          f"{min(cand)}, max {max(cand)}); launches "
          f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    print(f"trained fused path card vs CPU: F1 equal in "
          f"{len(f1) - len(f1_notes)} of {len(f1)} streams"
          + (f" (differs at ties in {', '.join(f1_notes)})" if f1_notes
             else "") + f"; results equal away from {tie_frames} detector "
          f"tie frame(s) and {fog_ties} fog tie(s); {flips} codec call(s) "
          f"with a half-step tie [{card}]")
    if not mean_f1 > mean_random:
        raise AssertionError(f"trained F1 {mean_f1:.3f} not above the "
                             f"random weights' {mean_random:.3f}")
    return f1


def phase_trained_learning(torch, np, card, trained):
    """The learning plane as ``serve --learning --per-site-learning
    --ensemble-serving`` runs it on the trained weights (8 streams x 8
    chunks x 4 frames; camera 0 drifts in its second half; no episode
    opened by hand, the drift detector at serve's warm-up)."""
    import argparse

    from repro_torch.launch import serve
    args = argparse.Namespace(
        video_streams=8, video_chunks=8, video_frames=4, learning=True,
        per_site_learning=True, ensemble_serving=True, label_budget=256,
        drift_window=8)
    cfg = serve.learning_config(args)
    plane, multi, counts, wall, _, rounds = run_learning(
        torch, "cuda", (trained["detector"], trained["classifier"]),
        serve.drifted_streams(args), cfg, forced=False)
    s = plane.summary()
    n_rounds = sum(site["trainer"]["rounds"] for site in s["sites"].values())
    print(f"trained learning plane ({args.video_streams} streams x "
          f"{args.video_chunks} chunks x {args.video_frames} frames, cam0 "
          f"drifts from chunk {args.video_chunks // 2}): {wall:.3f} s wall; "
          f"{s['drift_events']} drift event(s), labels charged "
          f"{s['labels_charged']} of {cfg.label_budget}, {n_rounds} "
          f"training round(s), {s['promotions']} promotion(s), "
          f"{s['ensemble_promotions']} ensemble promotion(s), "
          f"{s['rollbacks']} rollback(s), {s['hot_swaps']} hot swap(s); K5 "
          f"{counts['onevsall_update']} launches, {counts['onevsall_steps']}"
          f" steps [{card}]")
    serve.print_learning_summary(s)
    if s["labels_charged"] > cfg.label_budget:
        raise AssertionError("labels charged over the budget")
    if counts["onevsall_update"] != n_rounds:
        raise AssertionError(f"K5 launched {counts['onevsall_update']} "
                             f"times for {n_rounds} rounds")
    for name in VIDEO_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"trained learning run launched no {name}")
    check_nms_launches(counts, "trained learning run")
    return s


# ---------------------------------------------------------------------------
# the sharded, claim-check and multi-tenant serving planes (M9), on the
# trained full-width video models
# ---------------------------------------------------------------------------
SHARD_K = 4                               # shards of the oracle and timed run
SHARD_STREAMS, SHARD_CHUNKS, SHARD_FRAMES = 64, 2, 4
TENANTS = ("vision", "cascade", "retail", "vision")   # one stream each


def video_graph(params, device="cuda"):
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro_torch.core.protocol import HighLowProtocol
    from repro_torch.serving.graph import VideoFunctionGraph
    return VideoFunctionGraph(
        HighLowProtocol(DETECTOR, CLASSIFIER, device=device), *params)


def submit_streams(sched, streams, W, **kw):
    """Stream i as ``cam{i}`` with its chunks submitted; returns the
    submitted chunks by stream name."""
    submitted = {}
    for i, chunks in enumerate(streams):
        st = sched.add_stream(f"cam{i}", W=W, **kw)
        for c in chunks:
            sched.submit(st, c, learn=False)
        submitted[st.name] = list(chunks)
    return submitted


def check_same_results(sched_a, sched_b, what: str):
    """Every stream's results bitwise equal in the two schedulers."""
    from repro_torch.testing import results_mismatch
    bad = {name: results_mismatch(st, sched_b.streams[name])
           for name, st in sched_a.streams.items()}
    bad = {k: v for k, v in bad.items() if v is not None}
    if bad:
        raise AssertionError(f"{what}: results differ: {bad}")


def check_reports(rep_a, rep_b, what: str, peaks: bool = True):
    """The simulated-clock throughput-report keys equal (the JAX package's
    tests/test_shards.py skip list)."""
    from repro_torch.testing import report_mismatches
    keys = report_mismatches(rep_a, rep_b, peaks=peaks)
    if keys:
        raise AssertionError(f"{what}: report keys differ: "
                             + ", ".join(f"{k} {rep_a.get(k)!r} vs "
                                         f"{rep_b.get(k)!r}" for k in keys))


def check_conservation(sched, submitted, what: str):
    """Every submitted chunk finalized exactly once, in order, on its own
    stream, and no claim left in the store."""
    from repro_torch.testing import conservation_errors
    bad = conservation_errors(sched.streams, submitted)
    if bad:
        raise AssertionError(f"{what}: chunks lost, repeated or reordered "
                             f"on {bad}")
    store = getattr(sched, "store", None)
    if store is not None and store.live_refs():
        raise AssertionError(f"{what}: live store references at the end: "
                             f"{store.live_refs()}")


def phase_shard_oracle(torch, np, card, params):
    """K = SHARD_K shards against one GraphScheduler under the oracle's
    conditions (one chunk a flush, no window, no stealing): the main path's
    workload, per-stream results bitwise equal on the card and the
    simulated-clock report keys equal."""
    from repro_torch.serving.batching import CrossStreamBatcher
    from repro_torch.serving.graph import GraphScheduler
    from repro_torch.serving.shards import ShardedScheduler
    streams = make_streams(np, 8, 4, 4)
    graph = video_graph(params)
    oracle = GraphScheduler(
        graph, batcher=CrossStreamBatcher(max_chunks=1, window=0.0),
        hot_path="fused")
    sharded = ShardedScheduler(graph, num_shards=SHARD_K, steal=False,
                               hot_path="fused")
    walls = []
    for sched in (oracle, sharded):
        submitted = submit_streams(sched, streams, params[1]["W"])
        t0 = time.perf_counter()
        sched.drain()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check_conservation(sched, submitted, "shard oracle")
    check_same_results(oracle, sharded, f"{SHARD_K} shards vs one scheduler")
    check_reports(oracle.throughput_report(), sharded.throughput_report(),
                  f"{SHARD_K} shards vs one scheduler", peaks=False)
    print(f"shard oracle: {SHARD_K} shards (steal off, one chunk a flush) vs "
          f"one GraphScheduler, 8 streams x 4 chunks x 4 frames, trained "
          f"full width: results bitwise equal per stream, simulated-clock "
          f"report keys equal; walls {walls[0]:.3f} / {walls[1]:.3f} s "
          f"[{card}]")


def run_sharded(torch, params, streams, num_shards, device="cuda"):
    """``MultiStreamCoordinator(num_shards=, use_store=True)`` over
    ``streams``; returns (coordinator, launch counts, wall s)."""
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro_torch.core.coordinator import MultiStreamCoordinator
    from repro_torch.core.protocol import HighLowProtocol
    from repro_torch.kernels import ops
    multi = MultiStreamCoordinator(
        HighLowProtocol(DETECTOR, CLASSIFIER, device=device), *params,
        streams, max_batch_chunks=8, batch_window=0.02, hot_path="fused",
        num_shards=num_shards, use_store=True, device=device)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    multi.run(learn=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    multi.scheduler.drain()            # raises on a claim left in the store
    return multi, counts, wall


def phase_sharded(torch, np, card, params):
    """The sharded coordinator with the claim-check store on, at
    SHARD_STREAMS streams, K = 1 and K = SHARD_K in turns (1, K, K, 1: the
    host's speed drifts within a run): conservation, no live store
    reference, and the fleet's throughput figures.  Returns the launch
    counts of the last K = SHARD_K run."""
    run_sharded(torch, params, make_streams(np, SHARD_STREAMS, 1,
                                            SHARD_FRAMES), SHARD_K)  # warm-up
    streams = make_streams(np, SHARD_STREAMS, SHARD_CHUNKS, SHARD_FRAMES)
    frames = SHARD_STREAMS * SHARD_CHUNKS * SHARD_FRAMES
    turns = {1: [], SHARD_K: []}
    for k in (1, SHARD_K, SHARD_K, 1):
        multi, counts, wall = run_sharded(torch, params, streams, k)
        sched = multi.scheduler
        check_conservation(sched, {s.name: list(s.chunks)
                                   for s in multi.specs}, f"K = {k}")
        rep = multi.report()
        store = rep["store"]
        events = rep["sched_events"]
        host = rep["sched_step_wall_s"] - rep["sched_model_wall_s"]
        print(f"sharded coordinator K = {k} (store on, max_batch_chunks 8, "
              f"window 0.02): {SHARD_STREAMS} streams x {SHARD_CHUNKS} chunks"
              f" x {SHARD_FRAMES} frames, {wall:.3f} s wall, "
              f"{frames / wall:.1f} frames/s; {events} scheduler events, "
              f"host overhead {host / events * 1e6:.1f} us an event; "
              f"{rep['steals']} steals; {rep['calls']} detect calls; store "
              f"{store['puts']} puts, {store['dedup_hits']} dedup hits, "
              f"bytes current {store['bytes_current']:.0f}, peak "
              f"{store['bytes_peak']:.0f} (logical peak "
              f"{store['logical_bytes_peak']:.0f}); launches "
              f"{ {n: counts[n] for n in VIDEO_KERNELS} } [{card}]")
        turns[k].append((wall, host / events * 1e6))
        for name in VIDEO_KERNELS:
            if counts[name] == 0:
                raise AssertionError(f"sharded run K = {k} launched no "
                                     f"{name} kernel")
        check_nms_launches(counts, f"sharded run K = {k}")
        if k == SHARD_K:
            shard_counts = counts
    print(f"sharded coordinator in turns (K = 1, {SHARD_K}, {SHARD_K}, 1): "
          + "; ".join(
        f"K = {k} walls {', '.join(f'{w:.3f}' for w, _ in t)} s, host "
        f"overhead {', '.join(f'{h:.1f}' for _, h in t)} us an event"
        for k, t in turns.items()) + f" [{card}]")
    return shard_counts


def phase_steal_outage(torch, np, card, params):
    """tests/test_shards.py's work-stealing case at full width: 6 streams
    pinned to shard 0 of 2 with the same 3 chunks (so arrivals tie and one
    flush sees more than max_chunks), 2 replicas, replica 1 failing
    mid-run."""
    from repro_torch.core.bandwidth import NetworkModel
    from repro_torch.serving.batching import CrossStreamBatcher
    from repro_torch.serving.fault import FaultTolerantCoordinator
    from repro_torch.serving.shards import ShardedScheduler
    shared = make_streams(np, 1, 3, 4)[0]
    fault = FaultTolerantCoordinator(NetworkModel())
    fault.fail_replica(1, at=0.15)
    sharded = ShardedScheduler(
        video_graph(params), num_shards=2,
        batcher_factory=lambda i: CrossStreamBatcher(max_chunks=2,
                                                     window=0.05),
        hot_path="fused", cloud_replicas=2, fault=fault)
    submitted = submit_streams(sharded, [shared] * 6, params[1]["W"],
                               shard=0)
    sharded.drain()
    check_conservation(sharded, submitted, "stealing under an outage")
    rep = sharded.throughput_report()
    failovers = [e for e in fault.events if e["event"] == "replica_failover"]
    if not (sharded.steals > 0 and failovers
            and rep["batch_stolen"] == rep["batch_adopted"] == sharded.steals
            and sharded.router.load_report()["healthy"] == 1):
        raise AssertionError(f"stealing under an outage: {sharded.steals} "
                             f"steals, {len(failovers)} failovers, stolen "
                             f"{rep['batch_stolen']}, adopted "
                             f"{rep['batch_adopted']}")
    print(f"work stealing under an outage: 6 streams pinned to shard 0 of 2,"
          f" 3 shared chunks x 4 frames, replica 1 dies at t=0.15: "
          f"{sharded.steals} steals (stolen = adopted), "
          f"{len(failovers)} replica_failover event(s), "
          f"{rep['chaos_requeues']} requeue(s), every chunk finalized once "
          f"in order [{card}]")


def tenancy_run(torch, params, streams, device="cuda"):
    """tests/test_tenancy.py's three pipelines on one fleet at full width:
    vision (GOLD, the video models), cascade (SILVER) and retail (BRONZE)
    on a 2-shard ShardedScheduler with a CostModel.  Returns (scheduler,
    stream states, report, launch counts)."""
    from repro_torch.configs.vpaas_video import DETECTOR
    from repro_torch.kernels import ops
    from repro_torch.serving.batching import CrossStreamBatcher
    from repro_torch.serving.shards import ShardedScheduler
    from repro_torch.serving.tenancy import (BRONZE, GOLD, SILVER, CostModel,
                                             Tenancy, TenantSpec,
                                             content_pipeline,
                                             llm_cascade_pipeline)
    graph = video_graph(params, device)
    cost = CostModel()
    sched = ShardedScheduler(
        graph, num_shards=2, cost_model=cost, hot_path="fused",
        batcher_factory=lambda i: CrossStreamBatcher(max_chunks=4,
                                                     window=0.05))
    ten = Tenancy(graph, cost)
    hw = DETECTOR.image_hw
    ten.register(TenantSpec("vision", GOLD, weight=4.0))
    ten.register(TenantSpec("cascade", SILVER, weight=2.0,
                            pipeline=llm_cascade_pipeline(image_hw=hw,
                                                          device=device)))
    ten.register(TenantSpec("retail", BRONZE, weight=1.0,
                            pipeline=content_pipeline(image_hw=hw,
                                                      device=device)))
    states = [ten.add_stream(sched, t, f"cam{i}",
                             **({"W": params[1]["W"]} if t == "vision"
                                else {}))
              for i, t in enumerate(TENANTS)]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    ops.reset_launch_counts()
    for st, chunks in zip(states, streams):
        for c in chunks:
            sched.submit(st, c, learn=False)
    t0 = time.perf_counter()
    sched.drain()
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    cost.close(max(s.clock for s in states))
    check_conservation(sched, {st.name: list(c)
                               for st, c in zip(states, streams)}, "tenancy")
    return sched, states, sched.throughput_report(), counts, wall


def compare_tenant_outputs(np, card_states, cpu_states):
    """The pipeline tenants' outputs, card vs CPU: cascade answers and
    escalations equal, retail product ids equal and scores within 1e-5.
    Returns the chunks compared."""
    n = 0
    for a, b in zip(card_states, cpu_states):
        if a.tenant.pipeline is None:
            continue
        for (c1, r1, _), (c2, r2, _) in zip(a.results, b.results):
            x, y = r1.outputs, r2.outputs
            if c1 is not c2 or x.keys() != y.keys():
                raise AssertionError(f"{a.name}: results out of step")
            if "answers" in x:
                if not (np.array_equal(x["answers"], y["answers"])
                        and x["escalated"] == y["escalated"]):
                    raise AssertionError(f"{a.name}: cascade answers differ "
                                         f"card vs CPU: {x} vs {y}")
            else:
                if not np.array_equal(x["products"], y["products"]):
                    raise AssertionError(f"{a.name}: product ids differ card"
                                         f" vs CPU: {x} vs {y}")
                np.testing.assert_allclose(x["scores"], y["scores"],
                                           atol=1e-5, err_msg=a.name)
            n += 1
    return n


def phase_tenancy(torch, np, card, params):
    """Three tenants on one 2-shard fleet at full width: the cost ledger
    conserves (the fsum of the tenants equals the total within 1e-12), and
    the same run on the CPU (fed the card's decoded frames) gives the
    pipeline tenants' outputs.  Returns the card run's launch counts."""
    import math

    from repro_torch.testing import CodecTap
    from repro_torch.training.optimizer import tree_map
    streams = make_streams(np, len(TENANTS), 3, 4)
    with CodecTap() as rec:
        sched, states, rep, counts, wall = tenancy_run(torch, params,
                                                       streams)
    cr = rep["cost"]
    per_tenant = math.fsum(v["total_usd"] for v in cr["tenants"].values())
    if not abs(per_tenant - cr["total_usd"]) <= 1e-12 * cr["total_usd"]:
        raise AssertionError(f"cost ledger: tenants sum to {per_tenant!r}, "
                             f"fleet {cr['total_usd']!r}")
    if sum(v["chunks"] for v in cr["tenants"].values()) != 3 * len(TENANTS):
        raise AssertionError(f"cost ledger chunks: {cr['tenants']}")
    cpu_params = tuple(tree_map(lambda t: t.cpu(), p) for p in params)
    with CodecTap(lambda kind, f, r, q, i: rec.frames[i]):
        _, cpu_states, cpu_rep, _, cpu_wall = tenancy_run(
            torch, cpu_params, streams, device="cpu")
    compared = compare_tenant_outputs(np, states, cpu_states)
    for name, v in cr["tenants"].items():
        if v["chunks"] != cpu_rep["cost"]["tenants"][name]["chunks"]:
            raise AssertionError(f"{name}: chunks card vs CPU differ")
    print(f"tenancy: vision GOLD + cascade SILVER + retail BRONZE, "
          f"{len(TENANTS)} streams x 3 chunks x 4 frames on 2 shards, full "
          f"width: {wall:.3f} s wall (CPU {cpu_wall:.3f} s); fleet "
          f"${cr['total_usd']:.6e}, tenants' fsum equal within 1e-12; "
          + "; ".join(f"{n} {v['chunks']} chunks {v['invocations']} "
                      f"invocations ${v['total_usd']:.3e} SLO "
                      f"{rep['tenants'][n]['slo_attainment']:.2f}"
                      for n, v in sorted(cr["tenants"].items()))
          + f"; {rep['steals']} steals; card vs CPU: {compared} pipeline "
          f"chunks equal (answers, product ids; scores within 1e-5); "
          f"launches { {n: counts[n] for n in VIDEO_KERNELS} } [{card}]")
    for name in VIDEO_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"tenancy run launched no {name} kernel")
    check_nms_launches(counts, "tenancy run")
    return counts


# ---------------------------------------------------------------------------
# the LLM path's kernels: K6 flash attention, K7 decode attention, K8 SSD
# ---------------------------------------------------------------------------
def _attn_ops_per_pair(d, softcap, d_v=None):
    # q.k (2d) and p.v (2 d_v), scale, running max, exp, sum; softcap adds a
    # division, a tanh and a multiply
    return 2 * d + 2 * (d_v or d) + 5 + (3 if softcap else 0)


def flash_bound(b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap,
                size=4):
    """(bytes, operations, causal pairs of one head) K6's function needs:
    q and the output once, each K and V row some query reads once (``size``
    bytes a value), the offsets; every (query, key) pair the mask lets
    through."""
    import numpy as np
    pairs, keys = masked_pairs(np, s_q, s_kv, causal, window, 0)
    pairs *= b
    nbytes = size * (b * s_q * n_q * (d + d_v)
                     + b * keys * n_kv * (d + d_v)) + 4 * b
    return nbytes, pairs * n_q * _attn_ops_per_pair(d, cap, d_v), pairs


def flash_tc_bound(nbytes, head_pairs, d, d_v, cap):
    """K6's float32 bound with its products on the tensor cores: q.k and
    p.v (2 (d + d_v) a (query head, key) pair, as
    ``flash_attention.pair_work`` counts them) in 3xTF32, the softmax on
    the CUDA cores (:func:`tc_bound_ms`)."""
    mma = head_pairs * 2 * (d + d_v)
    return tc_bound_ms(nbytes, mma, head_pairs
                       * _attn_ops_per_pair(d, cap, d_v) - mma)


def k6_instance(fa, b, s_q, n_q, d, d_v, dtype) -> str:
    """The name (as ptxas reports it) of the K6 kernel instance that the
    launcher runs on these operands: its dispatch's head-dim steps, the
    routes and the bf16 block rows asked of the built library.  Where this
    run built the library, ptxas must have named that instance."""
    name = _k6_instance(fa, b, s_q, n_q, d, d_v, dtype)
    from repro_torch.kernels import _build
    if _build.build_log and not kernel_ptxas(name + ":"):
        raise AssertionError(f"K6 routes {d}/{d_v} {dtype} to {name}, "
                             f"which ptxas did not compile")
    return name


def _k6_instance(fa, b, s_q, n_q, d, d_v, dtype) -> str:
    import torch
    if dtype == torch.bfloat16 and fa.on_tensor_cores(d, d_v, dtype):
        dp = -(-d // 8) * 8
        nkt = next(n for n in (2, 4, 6, 7, 8, 16) if 16 * n >= dp)
        nwg = fa.block_rows(b, s_q, n_q) // 64
        return f"flash_attention_wgmma_kernel<{nwg}, {nkt}>"
    if dtype == torch.float32 and fa.on_tensor_cores(d, d_v):
        if d == d_v and d > 128:           # 32-row blocks of column warps
            return "flash_attention_cols_kernel"
        if d == d_v:
            ndt = nvt = next(n for n in (4, 8, 12, 14, 16) if 8 * n >= d)
        else:
            ndt = next(n for n in (8, 12, 16, 24) if 8 * n >= d)
            nvt = 8 if d_v <= 64 else 16
        rw = 4 if d <= 128 else 2          # row warps: 32-row blocks past 128
        return f"flash_attention_mma_kernel<{ndt}, {nvt}, {rw}>"
    nc = 2 if d_v <= 64 else 4 if d_v <= 128 else 8
    elem = "bf16" if dtype == torch.bfloat16 else "float"
    return f"flash_attention_simt_kernel<{elem}, {nc}>"


def k7_instance(da, q, kc, vc) -> str:
    """The name (as ptxas reports it) of the K7 split kernel instance that
    the launcher runs on these operands: the bf16 TMA kernel by its
    head-dim steps where :func:`decode_attention.on_tma` takes them, the
    float32 bulk kernel by the q-heads a warp carries where
    :func:`decode_attention.on_bulk` does, else the split kernel by element
    type and q-heads a block.  Where this run built the library, ptxas
    must have named that instance."""
    import torch
    d, group = q.shape[-1], q.shape[1] // kc.shape[2]
    if da.on_tma(q, kc, vc):
        name = ("decode_tma_kernel<"
                f"{next(n for n in (2, 4, 6, 7, 8, 16) if 16 * n >= d)}>")
    elif da.on_bulk(q, kc, vc):
        name = f"decode_bulk_kernel<{group if group <= 2 else 4}>"
    else:
        g = 1 if group == 1 else 2 if group == 2 else 4 if group <= 4 else 8
        elem = "bf16" if q.dtype == torch.bfloat16 else "float"
        name = f"decode_split_kernel<{elem}, {g}>"
    return _built(name)


def k8_instances(sk, p, n, dtype) -> list:
    """The names of the K8 kernel instances that the launcher runs for head
    dim ``p``, state ``n`` and x's ``dtype``, in launch order."""
    import torch
    elem = "bf16" if dtype == torch.bfloat16 else "float"
    if sk.path(p, n) != "tensor cores":
        return [_built(f"ssd_simt_kernel<{elem}>")]
    pn = {(64, 64): "8, 8", (64, 128): "8, 16"}.get((p, n), "0, 0")
    return [_built(f"ssd_state_kernel<{elem}, {pn}>"),
            _built("ssd_state_pass_kernel<4>"),     # aligned operands
            _built(f"ssd_output_kernel<{elem}, {pn}>")]


def k7_tma_smem(d: int) -> int:
    """Dynamic shared memory of K7's bf16 TMA kernel at head dim ``d``
    (``csrc/decode_attention.cu`` ``tma::Tile``): a 64 KB ring of K and V
    stages (a 64-column box of 4 heads x 16 slots, 8 KB, per 64 columns
    of the padded head dim; three 64 KB stages at d = 256) and its
    mbarriers, past d = 128 Q's fragments (4 warps x 16 k steps x 32 lanes
    x 16 bytes), asked as at least 120 KB so that one block holds an
    SM."""
    nkt = next(n for n in (2, 4, 6, 7, 8, 16) if 16 * n >= d)
    stage = 2 * -(-16 * nkt // 64) * 8192
    stages = 65536 // stage if stage < 65536 else 3
    q = 4 * nkt * 32 * 16 if nkt > 8 else 0
    return max(stages * stage + 16 * stages + q, 120 << 10)


def k8_smem(p: int, n: int, chunk: int, bf16: bool) -> dict:
    """Dynamic shared memory of K8's state and output kernels
    (``csrc/ssd_scan.cu`` ``tc::state_smem_bytes`` / ``output_smem_bytes``:
    bf16 tiles at half the bytes, row strides as there)."""
    e = 2 if bf16 else 4
    rows = (lambda w: w + 8) if bf16 else (lambda w: w + 4)
    cols = ((lambda w: -(-w // 64) * 64 + 16) if bf16 else
            (lambda w: w if w % 16 else w + 8))
    qp = -(-chunk // 64) * 64
    return {"state": e * 2 * 64 * (cols(p) + cols(n)) + 4 * 2 * qp + 8 * 8,
            "output": e * (3 * 64 * rows(n) + 2 * 64 * rows(p))
            + 4 * (p * (n + 4) + 2 * qp) + 8 * 8}


def _built(name: str) -> str:
    from repro_torch.kernels import _build
    if _build.build_log and not kernel_ptxas(name + ":"):
        raise AssertionError(f"{name}: ptxas did not compile it")
    return name


def instance_ptxas(names) -> list:
    """ptxas's register, shared-memory and spill line of each instance."""
    return [line for name in names for line in kernel_ptxas(name + ":")]


# the K6 shapes of the LLM paths, q_offset 0: (b, s_q, s_kv, n_q, n_kv, d,
# d_v, causal, window, softcap, what)
FLASH_PATH_SHAPES = (
    (1, 384, 512, 32, 32, 112, 112, True, None, None,
     "zamba2 cache prefill"),
    (1, 384, 512, 32, 16, 256, 256, True, 64, 50.0,
     "GQA, window and softcap at d = 256"),
    (1, 384, 512, 16, 8, 256, 256, True, None, 50.0,
     "gemma2 cache prefill, global layer"),
    (1, 384, 512, 16, 8, 256, 256, True, 4096, 50.0,
     "gemma2 cache prefill, LOCAL layer"),
    (1, 384, 512, 16, 16, 192, 128, True, None, None,
     "deepseek-v2-lite MLA cache prefill"),
    (4, 384, 512, 24, 24, 64, 64, True, None, None,
     "musicgen self-attention cache prefill"),
    (4, 384, 256, 24, 24, 64, 64, False, None, None,
     "musicgen cross-attention prefill"),
    (4, 1, 256, 24, 24, 64, 64, False, None, None,
     "musicgen cross-attention decode step"),
)


def phase_flash_attention(torch, np, card):
    """K6 against its plain version at each LLM path's shapes (timed, with
    SDPA in turns where it computes the same function), then its error at
    every shape of the CPU tests' cases.  Returns the zamba2 row, the other
    shapes' rows under ``other_shapes`` and the errors under
    ``case_errors``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.testing import (ATTN_ATOL, FLASH_CASES, FLASH_DV_CASES,
                                     FLASH_EDGE_CASES, FLASH_RAGGED_CASES,
                                     FLASH_WIDE_CASES, attention_case)
    rows = []
    for (b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap,
         what) in FLASH_PATH_SHAPES:
        q, k, v = (torch.as_tensor(a, device="cuda") for a in
                   attention_case(b, s_q, s_kv, n_q, n_kv, d, seed=SEED,
                                  d_v=d_v))
        off = torch.zeros((), dtype=torch.int32, device="cuda")
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= ATTN_ATOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K6 at {what}: max abs error {err} exceeds "
                                 f"{ATTN_ATOL}")
        kernel = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = measure(torch, lambda: fa.flash_attention_ref(q, k, v, **kw))
        lib = turns = nocap = None
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if cap is None and window is None:
            # the same function: causal from the top-left corner is
            # q_offset 0, and SDPA takes a value head dim of its own;
            # (b, heads, seq, d) layout made outside the timing
            timed, lib, turns = versus_library(
                torch, kernel, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), once=True)
        elif d > 128:
            # SDPA without the softcap and the window: not the same
            # function (no single PyTorch call computes attention with a
            # softcap), the d = 256 rows' yardstick, as the bf16 rows'
            timed, nocap, turns = versus_library(
                torch, kernel, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=n_q != n_kv),
                once=True)
        else:
            timed = measure(torch, kernel, once=True)
        del qt, kt, vt
        nbytes, ops, pairs = flash_bound(b, s_q, s_kv, n_q, n_kv, d, d_v,
                                         causal, window, cap)
        row = _row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:86",
                   f"b={b} s_q={s_q} s_kv={s_kv} heads={n_q}/{n_kv} d={d} "
                   f"d_v={d_v} causal={causal} window={window} "
                   f"softcap={cap}", err, timed, plain,
                   None if lib is None else lib[0], nbytes, ops)
        tc = ", CUDA cores"
        if fa.on_tensor_cores(d, d_v):
            row["bound_tc_ms"], row["bound_tc_by"] = flash_tc_bound(
                nbytes, pairs * n_q, d, d_v, cap)
            tc = (f", tensor-core bound {row['bound_tc_ms']:.6f} ms "
                  f"({row['bound_tc_by']})")
        row["kernel"] = k6_instance(fa, b, s_q, n_q, d, d_v, q.dtype)
        row["ptxas"] = instance_ptxas([row["kernel"]])
        tag = (f"K6 flash_attention {what} s_q={s_q} s_kv={s_kv} "
               f"{n_q}/{n_kv} heads d={d} d_v={d_v} causal={causal} "
               f"window={window} softcap={cap}")
        if lib is not None:
            row.update(library_device_ms=lib[1], turns_ms=turns)
        _report(f"{tag}: {row['kernel']}, max abs err {err:.3e}{tc}", row,
                card, "sdpa" if lib is not None else None)
        if lib is not None:
            _report_turns(tag, turns, row, "sdpa", card)
        if nocap is not None:
            report_uncapped(tag, row, timed, nocap, turns, card)
        row["what"] = what
        rows.append(row)
    main_row = rows[0]
    main_row["other_shapes"] = rows[1:]
    # the error at every shape of the CPU tests' cases (K6's tolerance is
    # tight against its 3xTF32 products: ROADMAP queue 3)
    errors = []
    cases = [c[:6] + (c[5],) + c[6:]          # d_v = d
             for c in FLASH_CASES + FLASH_RAGGED_CASES] + FLASH_DV_CASES \
        + FLASH_EDGE_CASES + FLASH_WIDE_CASES
    for b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off in cases:
        q, k, v = (torch.as_tensor(a, device="cuda") for a in
                   attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v))
        kw = dict(causal=causal, window=window, softcap=cap,
                  q_offset=torch.as_tensor(off, device="cuda"))
        got = fa.flash_attention(q, k, v, **kw)
        err = float((got - fa.flash_attention_ref(q, k, v, **kw))
                    .abs().max())
        shape = (f"b={b} s_q={s_q} s_kv={s_kv} heads={n_q}/{n_kv} d={d} "
                 f"d_v={d_v}")
        if not err <= ATTN_ATOL:
            raise AssertionError(f"K6 at the test case {shape}: max abs "
                                 f"error {err} exceeds {ATTN_ATOL}")
        errors.append({"shape": shape, "max_abs_err": err,
                       "tensor_cores": fa.on_tensor_cores(d, d_v),
                       "kernel": k6_instance(fa, b, s_q, n_q, d, d_v,
                                             q.dtype)})
    main_row["case_errors"] = errors
    print(f"K6 at the {len(errors)} test-case shapes: max abs err "
          + ", ".join(f"{e['max_abs_err']:.2e}" for e in errors)
          + f" (tolerance {ATTN_ATOL}) [{card}]")
    main_row["bf16"] = phase_flash_attention_bf16(torch, np, card)
    return main_row


def bf16_err(got, want) -> tuple:
    """(max abs error, ``testing.bf16_err``: the error as a share of the
    largest value in its row, with no floor) of a bf16 result against its
    plain version's, on the card."""
    from repro_torch.testing import bf16_err as row_err
    diff = float((got.float() - want.float()).abs().max())
    return diff, row_err(got, want)


def bf16_steps(torch, got, want32) -> dict:
    """How far a bf16 result lies from its float32 plain version: the
    outputs equal to ``want32`` rounded to bf16, one bf16 step from it and
    further (``steps``), and the largest |got - want32| in bf16 ulps of
    ``want32`` (``max_ulps``; rounding alone gives at most 0.5)."""
    def ordered(t):                       # bf16 bits as integers in order
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    steps = (ordered(got) - ordered(want32.to(torch.bfloat16))).abs()
    ulp = torch.ldexp(torch.ones_like(want32), torch.frexp(want32)[1] - 8)
    return {"steps": {"0": int((steps == 0).sum()),
                      "1": int((steps == 1).sum()),
                      ">1": int((steps > 1).sum())},
            "max_ulps": float(((got.float() - want32).abs() / ulp).max())}


def _bf16_row(name, source, replaces, shape, errs, timed, plain, lib,
              bound, tol):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                shape=shape, dtype="bfloat16", max_abs_err=errs[0],
                rel_err=errs[1], tolerance=tol, ms=timed[0],
                device_ms=timed[1], plain_ms=plain[0],
                plain_device_ms=plain[1], bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib)


def _bf16_report(tag, row, card):
    flags = flag_below_bound(row)
    lib = ("" if row["library_ms"] is None else
           f", sdpa bf16 {fmt(row['library_ms'])} "
           f"({fmt(row.get('library_device_ms'))} on the device)")
    print(f"{tag}: error {row['max_abs_err']:.3e} ({row['rel_err']:.3e} of "
          f"its row's largest value; tolerance {row['tolerance']:.3e}); "
          f"kernel "
          f"{fmt(row['ms'])} per call ({fmt(row['device_ms'])} on the "
          f"device), plain {fmt(row['plain_ms'])} "
          f"({fmt(row['plain_device_ms'])} on the device){lib}, bf16 bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']}){flags} [{card}]")


def phase_flash_attention_bf16(torch, np, card):
    """K6 on bf16 operands against its plain version (same operands), at
    each LLM path's K6 shape and every CPU test case's: error, kernel,
    plain and device times, the bf16 bound, and SDPA's bf16 time where it
    computes the same function.  Returns the zamba2 prefill's row, the
    others under ``other_shapes``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.testing import (ATTN_BF16_RTOL, FLASH_CASES,
                                     FLASH_DV_CASES, FLASH_EDGE_CASES,
                                     FLASH_RAGGED_CASES, attention_case)
    cases = [c[:10] + (0, c[10]) for c in FLASH_PATH_SHAPES] + [
        c[:6] + (c[5],) + c[6:] + ("test case",)
        for c in FLASH_CASES + FLASH_RAGGED_CASES] + [
        c + ("test case",) for c in FLASH_DV_CASES] + [
        c + ("tile edge",) for c in FLASH_EDGE_CASES]
    rows = []
    for (b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off,
         what) in cases:
        q, k, v = (torch.as_tensor(a, device="cuda").to(torch.bfloat16)
                   for a in attention_case(b, s_q, s_kv, n_q, n_kv, d,
                                           seed=SEED, d_v=d_v))
        kw = dict(causal=causal, window=window, softcap=cap,
                  q_offset=torch.as_tensor(off, dtype=torch.int32,
                                           device="cuda"))
        got = fa.flash_attention(q, k, v, **kw)
        errs = bf16_err(got, fa.flash_attention_ref(q, k, v, **kw))
        if not (got.dtype == torch.bfloat16 and errs[1] <= ATTN_BF16_RTOL
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K6 bf16 at {what} {q.shape}: error "
                                 f"{errs} over {ATTN_BF16_RTOL}")
        kernel = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        reps = 30 if what not in ("test case", "tile edge") else 5
        plain = measure(torch, lambda: fa.flash_attention_ref(q, k, v, **kw),
                        reps)
        # one kernel a call, unless the wrapper pads d for TMA first
        once = fa.tma_ready(q, k, v) or d != d_v or d > 128
        lib_t = (None, None)
        if cap is None and window is None and off == 0:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            timed, lib_t, _ = versus_library(
                torch, kernel, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal,
                    enable_gqa=n_q != n_kv), reps, once=once)
        else:
            timed = measure(torch, kernel, reps, once=once)
        # each batch row's pairs and the keys its queries read, at its own
        # query offset
        pairs, keys = map(sum, zip(*(
            masked_pairs(np, s_q, s_kv, causal, window, int(o))
            for o in np.broadcast_to(np.asarray(off), (b,)))))
        nbytes = 2 * (b * s_q * n_q * (d + d_v) + keys * n_kv * (d + d_v)) \
            + 4 * b
        mma = pairs * n_q * 2 * (d + d_v)
        other = pairs * n_q * (_attn_ops_per_pair(d, cap, d_v)
                               - 2 * (d + d_v))
        shape = (f"b={b} s_q={s_q} s_kv={s_kv} heads={n_q}/{n_kv} d={d} "
                 f"d_v={d_v} causal={causal} window={window} softcap={cap} "
                 f"q_offset={off}")
        row = _bf16_row("flash_attention",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:86", shape,
                        errs, timed, plain, lib_t[0],
                        bf16_bound_ms(nbytes, mma, other), ATTN_BF16_RTOL)
        row.update(what=what,
                   tensor_cores=fa.on_tensor_cores(d, d_v, q.dtype),
                   kernel=k6_instance(fa, b, s_q, n_q, d, d_v, q.dtype),
                   library_device_ms=lib_t[1])
        _bf16_report(f"K6 bf16 flash_attention {what} {shape}, "
                     f"{row['kernel']}", row, card)
        rows.append(row)
    rows[0]["other_shapes"] = rows[1:]
    return rows[0]


def masked_pairs(np, s_q, s_kv, causal, window, off) -> tuple:
    """(the (query, key) pairs of one batch row and head the mask lets
    through, the keys some query reads) with the queries at positions
    off .. off + s_q - 1."""
    qp = np.arange(s_q)[:, None] + off
    kp = np.arange(s_kv)[None, :]
    mask = np.ones((s_q, s_kv), bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    return int(mask.sum()), int(mask.any(0).sum())


def device_kernels(avgs, reps: int):
    """The device kernels of a profiled call: ((name, launches per call as
    the profiler counted them), ...) by device time, and the number of
    distinct kernels."""
    dev = sorted((e for e in avgs if _self_device_us(e) > 0),
                 key=_self_device_us, reverse=True)
    return [(e.key, e.count / reps) for e in dev], len(dev)


def decode_rows(lens, S, window) -> int:
    """Valid cache rows of a K7 call: slots [len - window, len) or
    [0, len) of each batch row, within the S slots."""
    lens = [max(0, min(n, S)) for n in lens]
    return sum(n - (max(0, n - window) if window else 0) for n in lens)


def decode_nbytes(b, n_q, n_kv, d, lens, S, window, size=4) -> int:
    """Bytes K7's function must move: q and the output, each valid K and V
    row once (``size`` bytes a value), the lengths."""
    rows = decode_rows(lens, S, window)
    return size * (2 * b * n_q * d + 2 * rows * n_kv * d) + 4 * b


# the K7 shapes of the LLM paths: (b, S, n_q, n_kv, d, cache lengths,
# window, softcap); four slots at the main paths' decode lengths (zamba2's
# d = 112 and musicgen's self-attention at d = 64), then GQA / window /
# softcap at d = 256, then gemma2-9b's global and LOCAL layers
DECODE_PATH_SHAPES = (
    (4, 512, 32, 32, 112, [385, 390, 395, 399], None, None),
    (4, 512, 24, 24, 64, [385, 390, 395, 399], None, None),
    (4, 512, 32, 16, 256, [385, 390, 395, 399], 64, 50.0),
    (4, 512, 16, 8, 256, [385, 390, 395, 399], None, 50.0),
    (4, 512, 16, 8, 256, [385, 390, 395, 399], 4096, 50.0),
)


def phase_decode_attention(torch, np, card):
    """K7 against its plain version at each LLM path's decode shape (timed,
    with SDPA in turns where it computes the same function).  Returns the
    first row, the other shapes' rows under ``other_shapes``."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.testing import (ATTN_ATOL, DECODE_CASES,
                                     DECODE_WIDE_CASES, decode_case)
    rows = []
    for b, S, n_q, n_kv, d, clen, window, cap in DECODE_PATH_SHAPES:
        q, kc, vc = (torch.as_tensor(a, device="cuda") for a in
                     decode_case(b, S, n_q, n_kv, d, seed=SEED))
        cl = torch.as_tensor(clen, dtype=torch.int32, device="cuda")
        kw = dict(window=window, softcap=cap)
        got = da.decode_attention(q, kc, vc, cl, **kw)
        want = da.decode_attention_ref(q, kc, vc, cl, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= ATTN_ATOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K7 at d={d}: max abs error {err} exceeds "
                                 f"{ATTN_ATOL}")
        if not torch.equal(da.decode_attention(q, kc, vc, cl, **kw), got):
            raise AssertionError(f"K7 at d={d}: not bit-identical run to run")
        kernel = lambda: da.decode_attention(q, kc, vc, cl, **kw)  # noqa: E731
        plain = measure(torch, lambda: da.decode_attention_ref(q, kc, vc, cl,
                                                               **kw))
        lib = turns = sdpa_kernels = nocap = None
        valid = (torch.arange(S, device="cuda")[None, :]
                 < cl[:, None].long())[:, None, None, :]
        qt = q[:, :, None, :]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        if cap is None and window is None:
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=valid)
            timed, lib, turns = versus_library(torch, kernel, sdpa)
            # SDPA picks its backend itself for an fp32 boolean mask
            sdpa_kernels = device_kernels(profile_device(torch, sdpa, 10)[1],
                                          10)[0]
        elif d > 128:
            # without the softcap and the window: not the same function
            timed, nocap, turns = versus_library(
                torch, kernel, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=valid, enable_gqa=n_q != n_kv))
        else:
            timed = measure(torch, kernel)
        del qt, kt, vt
        names, per_call = device_kernels(profile_device(torch, kernel, 10)[1],
                                         10)
        nbytes = decode_nbytes(b, n_q, n_kv, d, clen, S, window)
        ops = decode_rows(clen, S, window) * n_q * _attn_ops_per_pair(d, cap)
        row = _row("decode_attention",
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:73",
                   f"b={b} S={S} heads={n_q}/{n_kv} d={d} lens={clen} "
                   f"window={window} softcap={cap}", err, timed, plain,
                   None if lib is None else lib[0], nbytes, ops)
        per, nsplit = da.plan(q, kc, vc, window)
        row.update(splits=nsplit, device_kernels_per_call=per_call,
                   kernel=k7_instance(da, q, kc, vc))
        row["ptxas"] = instance_ptxas([row["kernel"]])
        tag = (f"K7 decode_attention b={b} S={S} {n_q}/{n_kv} heads d={d} "
               f"window={window} softcap={cap}")
        if lib is not None:
            row.update(library_device_ms=lib[1], turns_ms=turns,
                       library_kernels=[n for n, _ in sdpa_kernels])
        _report(f"{tag}: {row['kernel']}, max abs err {err:.3e}, {nsplit} "
                f"splits of {per} slots, {per_call:g} device kernels per "
                f"call ({', '.join(n[:40] for n, _ in names)})", row, card,
                "sdpa" if lib is not None else None)
        if lib is not None:
            _report_turns(tag, turns, row, "sdpa", card)
            print("  sdpa's device kernels: " + "; ".join(
                f"{n[:80]} x{c:g}" for n, c in sdpa_kernels))
        if nocap is not None:
            report_uncapped(tag, row, timed, nocap, turns, card)
        rows.append(row)
    rows[0]["other_shapes"] = rows[1:]
    # the error at every shape of the CPU tests' cases (the bulk kernel's
    # at several emulated card sizes: here on this card's plan), each
    # bit-identical on a second call
    errors = []
    for b, S, n_q, n_kv, d, clen, window, cap in DECODE_CASES + [
            c for c, _ in DECODE_WIDE_CASES]:
        q, kc, vc = (torch.as_tensor(a, device="cuda") for a in
                     decode_case(b, S, n_q, n_kv, d, seed=SEED))
        cl = torch.as_tensor(np.broadcast_to(np.asarray(clen), (b,)).copy(),
                             dtype=torch.int32, device="cuda")
        kw = dict(window=window, softcap=cap)
        got = da.decode_attention(q, kc, vc, cl, **kw)
        err = float((got - da.decode_attention_ref(q, kc, vc, cl, **kw))
                    .abs().max())
        shape = (f"b={b} S={S} heads={n_q}/{n_kv} d={d} lens={clen} "
                 f"window={window} softcap={cap}")
        if not (err <= ATTN_ATOL and torch.equal(
                da.decode_attention(q, kc, vc, cl, **kw), got)):
            raise AssertionError(f"K7 at the test case {shape}: max abs "
                                 f"error {err} (tolerance {ATTN_ATOL}) or "
                                 f"not bit-identical run to run")
        errors.append({"shape": shape, "max_abs_err": err,
                       "kernel": k7_instance(da, q, kc, vc)})
    rows[0]["case_errors"] = errors
    print(f"K7 at the {len(errors)} test-case shapes: max abs err "
          + ", ".join(f"{e['max_abs_err']:.2e}" for e in errors)
          + f" (tolerance {ATTN_ATOL}), each bit-identical on a second "
            f"call [{card}]")
    rows[0]["bf16"] = phase_decode_attention_bf16(torch, np, card)
    return rows[0]


def phase_decode_attention_bf16(torch, np, card):
    """K7 on bf16 q and caches against its plain version, at each LLM
    path's decode shape and every CPU test case's: error, kernel, plain
    and device times, the bf16 bound (half the float32 bytes), and SDPA's
    bf16 time where it computes the same function.  Returns the zamba2
    decode's row, the others under ``other_shapes``."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.testing import ATTN_BF16_RTOL, DECODE_CASES, decode_case
    rows = []
    for i, (b, S, n_q, n_kv, d, clen, window, cap) in enumerate(
            list(DECODE_PATH_SHAPES) + list(DECODE_CASES)):
        what = "path" if i < len(DECODE_PATH_SHAPES) else "test case"
        q, kc, vc = (torch.as_tensor(a, device="cuda").to(torch.bfloat16)
                     for a in decode_case(b, S, n_q, n_kv, d, seed=SEED))
        cl = torch.as_tensor(np.broadcast_to(np.asarray(clen), (b,)).copy(),
                             dtype=torch.int32, device="cuda")
        kw = dict(window=window, softcap=cap)
        got = da.decode_attention(q, kc, vc, cl, **kw)
        errs = bf16_err(got, da.decode_attention_ref(q, kc, vc, cl, **kw))
        if not (got.dtype == torch.bfloat16 and errs[1] <= ATTN_BF16_RTOL
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K7 bf16 at b={b} S={S} d={d}: error "
                                 f"{errs} over {ATTN_BF16_RTOL}")
        kernel = lambda: da.decode_attention(q, kc, vc, cl, **kw)  # noqa
        reps = 30 if what == "path" else 5
        plain = measure(torch, lambda: da.decode_attention_ref(
            q, kc, vc, cl, **kw), reps)
        lib_t, turns = (None, None), None
        if cap is None and window is None:
            valid = (torch.arange(S, device="cuda")[None, :]
                     < cl[:, None].long())[:, None, None, :]
            kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
            timed, lib_t, turns = versus_library(
                torch, kernel, lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kt, vt, attn_mask=valid,
                    enable_gqa=n_q != n_kv), reps, once=True)
        else:
            timed = measure(torch, kernel, reps)
        lens = [int(x) for x in cl.tolist()]
        rows_valid = decode_rows(lens, S, window)
        nbytes = decode_nbytes(b, n_q, n_kv, d, lens, S, window, size=2)
        shape = (f"b={b} S={S} heads={n_q}/{n_kv} d={d} lens={lens} "
                 f"window={window} softcap={cap}")
        row = _bf16_row(
            "decode_attention", "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:73", shape, errs, timed,
            plain, lib_t[0], bf16_bound_ms(
                nbytes, rows_valid * n_q * 4 * d,
                rows_valid * n_q * (_attn_ops_per_pair(d, cap) - 4 * d)),
            ATTN_BF16_RTOL)
        kernel_name = k7_instance(da, q, kc, vc)
        row.update(what=what,
                   library_device_ms=lib_t[1], kernel=kernel_name,
                   ptxas=instance_ptxas([kernel_name]),
                   dynamic_smem=(k7_tma_smem(d) if da.on_tma(q, kc, vc)
                                 else None),
                   bound_f32_ms=bound_ms(
            decode_nbytes(b, n_q, n_kv, d, lens, S, window),
            rows_valid * n_q * _attn_ops_per_pair(d, cap))[0])
        smem = ("" if row["dynamic_smem"] is None else
                f", {row['dynamic_smem']:,} B dyn. smem")
        _bf16_report(f"K7 bf16 decode_attention {what} {shape}, "
                     f"{kernel_name}{smem} (float32's bound "
                     f"{row['bound_f32_ms']:.6f} ms)", row, card)
        if turns is not None:
            row["turns_ms"] = turns
            _report_turns(f"K7 bf16 decode_attention {what} {shape}", turns,
                          row, "sdpa bf16", card)
        rows.append(row)
    rows[0]["other_shapes"] = rows[1:]
    rows[0]["host_us"] = phase_k7_host(torch, card)
    return rows[0]


def ssd_ops(b, s, h, p, n) -> int:
    """Floating-point operations the SSD scan's function needs: the plain
    recurrence, per (row, head, step), the decay exp(dt A), u = dt x (p),
    the state update S <- exp(dt A) S + u B^T (3pn) and y = C S (2pn).  The
    chunked form the kernel runs does more; it is the TPU kernel's choice
    for its matrix units, not what the function costs."""
    return b * h * s * (5 * p * n + p + 2)


def ssd_tc_ops(b, s, h, p, n, chunk, bf16=False):
    """(matrix-product flops, other flops, bf16 products, products with
    one bf16 operand) of the chunked form K8 runs on the tensor cores
    (``kernels.ssd_scan.chunked_work``, which the dry run's floor charges
    too): on bf16 operands C B^T is one bf16 product and each other
    product two TF32 ones."""
    from repro_torch.kernels.ssd_scan import chunked_work
    return chunked_work(b, s, h, p, n, chunk, bf16)


def phase_ssd_scan(torch, np, card):
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.testing import SSD_RTOL, rel_err, ssd_case
    main_row = None
    # the zamba2 prefill (one full and one partial 256-step chunk), the
    # same with Mamba2's weakly decaying dt and an initial state, then a
    # carried initial state at mamba2's state width n = 128
    for b, s, h, p, n, chunk, init, weak in (
            (1, 384, 112, 64, 64, 256, False, False),
            (1, 384, 112, 64, 64, 256, True, True),
            (1, 384, 80, 64, 128, 256, True, False)):
        x, dt, A, B, C, st = (None if a is None else
                              torch.as_tensor(a, device="cuda") for a in
                              ssd_case(b, s, h, p, n, init, seed=SEED,
                                       weak=weak))
        kw = dict(chunk=chunk, initial_state=st)
        y, fin = sk.ssd_scan(x, dt, A, B, C, **kw)
        y_ref, fin_ref = sk.ssd_scan_ref(x, dt, A, B, C, **kw)
        torch.cuda.synchronize()
        err = max(rel_err(y.cpu(), y_ref.cpu()),
                  rel_err(fin.cpu(), fin_ref.cpu()))
        if not (err <= SSD_RTOL and bool(torch.isfinite(y).all())):
            raise AssertionError(f"K8 at n={n} weak_decay={weak}: error "
                                 f"{err} of the output "
                                 f"scale exceeds {SSD_RTOL}")
        y2, fin2 = sk.ssd_scan(x, dt, A, B, C, **kw)
        if not (torch.equal(y2, y) and torch.equal(fin2, fin)):
            raise AssertionError(f"K8 at n={n}: not bit-identical run to run")
        kernel = lambda: sk.ssd_scan(x, dt, A, B, C, **kw)  # noqa: E731
        timed = measure(torch, kernel)
        plain = measure(torch, lambda: sk.ssd_scan_ref(x, dt, A, B, C, **kw))
        names, per_call = device_kernels(profile_device(torch, kernel, 10)[1],
                                         10)
        nbytes = ssd_nbytes(b, s, h, p, n, init)
        row = _row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan.py:74",
                   f"b={b} s={s} h={h} p={p} n={n} chunk={chunk} "
                   f"initial_state={init} weak_decay={weak}", err, timed,
                   plain, None, nbytes, ssd_ops(b, s, h, p, n))
        mma, other, _, _ = ssd_tc_ops(b, s, h, p, n, chunk)
        row["bound_tc_ms"], row["bound_tc_by"] = tc_bound_ms(nbytes, mma,
                                                             other)
        row.update(path=sk.path(p, n), device_kernels_per_call=per_call)
        _report(f"K8 ssd_scan s={s} h={h} p={p} n={n} chunk={chunk} "
                f"initial_state={init} weak_decay={weak}: error {err:.3e} of "
                f"the output scale, {row['path']} path, {per_call:g} device "
                f"kernels per call ({', '.join(n_[:40] for n_, _ in names)}),"
                f" tensor-core bound {row['bound_tc_ms']:.6f} ms "
                f"({row['bound_tc_by']}; {mma / 1e9:.3f} GFLOP of products)",
                row, card)
        if main_row is None:
            main_row = row
    main_row["bf16"] = phase_ssd_scan_bf16(torch, np, card)
    return main_row


def ssd_nbytes(b, s, h, p, n, init, size=4) -> int:
    """Bytes K8's function must move: x and y, B and C (``size`` bytes a
    value), dt, A and the states (float32)."""
    return (size * (2 * b * s * h * p + 2 * b * s * n)
            + 4 * (b * s * h + h + (2 if init else 1) * b * h * p * n))


def phase_ssd_scan_bf16(torch, np, card):
    """K8 on bf16 x, B and C (dt, A and the states float32, as the Mamba2
    layer passes them) against its plain version, at the LLM paths' three
    shapes and every CPU test case's: error, kernel, plain and device
    times, the bound: the function's operations at fp32's rate, as the
    float32 rows count them, on bf16's bytes, and the tensor-core bound
    with C B^T (bf16 operands) at bf16's rate and the other products (a
    float32 operand beside a bf16 one) as two TF32 products each.  Returns
    the zamba2 prefill's row, the others under ``other_shapes``."""
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.testing import (SSD_BF16_RTOL, SSD_CASES, SSD_RTOL,
                                     rel_err, ssd_case)
    cases = [(1, 384, 112, 64, 64, 256, False, False, "path"),
             (1, 384, 112, 64, 64, 256, True, True, "path"),
             (1, 384, 80, 64, 128, 256, True, False, "path")] + [
        c + ("test case",) for c in SSD_CASES]
    rows = []
    for b, s, h, p, n, chunk, init, weak, what in cases:
        x, dt, A, B, C, st = (None if a is None else
                              torch.as_tensor(a, device="cuda") for a in
                              ssd_case(b, s, h, p, n, init, seed=SEED,
                                       weak=weak))
        x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
        kw = dict(chunk=chunk, initial_state=st)
        y, fin = sk.ssd_scan(x, dt, A, B, C, **kw)
        y_ref, fin_ref = sk.ssd_scan_ref(x, dt, A, B, C, **kw)
        errs = bf16_err(y, y_ref)
        # the final state is float32: held as the float32 rows hold it
        fin_err = rel_err(fin.cpu(), fin_ref.cpu())
        if not (y.dtype == torch.bfloat16 and fin.dtype == torch.float32
                and errs[1] <= SSD_BF16_RTOL and fin_err <= SSD_RTOL
                and bool(torch.isfinite(y).all())):
            raise AssertionError(f"K8 bf16 at s={s} h={h} p={p} n={n}: "
                                 f"y {errs}, final state {fin_err}")
        kernel = lambda: sk.ssd_scan(x, dt, A, B, C, **kw)  # noqa: E731
        reps = 30 if what == "path" else 5
        timed = measure(torch, kernel, reps)
        plain = measure(torch, lambda: sk.ssd_scan_ref(x, dt, A, B, C, **kw),
                        reps)
        nbytes = ssd_nbytes(b, s, h, p, n, init, size=2)
        shape = (f"b={b} s={s} h={h} p={p} n={n} chunk={chunk} "
                 f"initial_state={init} weak_decay={weak}")
        row = _bf16_row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan.py:74", shape, errs,
                        timed, plain, None,
                        bound_ms(nbytes, ssd_ops(b, s, h, p, n)),
                        SSD_BF16_RTOL)
        row["bound_tc_ms"], row["bound_tc_by"] = tc_bound_ms(
            nbytes, *ssd_tc_ops(b, s, h, p, n, chunk, bf16=True))
        names = k8_instances(sk, p, n, x.dtype)
        row.update(what=what, path=sk.path(p, n), final_state_err=fin_err,
                   kernels=names, ptxas=instance_ptxas(names),
                   dynamic_smem=(k8_smem(p, n, chunk, True)
                                 if sk.path(p, n) == "tensor cores"
                                 else None))
        smem = ("" if row["dynamic_smem"] is None else
                ", dyn. smem " + ", ".join(
                    f"{k} {v:,} B" for k, v in row["dynamic_smem"].items()))
        _bf16_report(f"K8 bf16 ssd_scan {what} {shape}, {row['path']} "
                     f"path ({', '.join(names)}{smem}), tensor-core bound "
                     f"{row['bound_tc_ms']:.6f} ms, final state "
                     f"{fin_err:.3e}", row, card)
        rows.append(row)
    rows[0]["other_shapes"] = rows[1:]
    return rows[0]


SPLIT_REPS = 10      # timed calls a split by device kernel takes the median of


def kernel_split(torch, fn, names, reps: int = SPLIT_REPS) -> dict:
    """The device time of each of a launcher's device kernels (``names``,
    in launch order) from CUDA events that the launcher records between
    them (``_build.time_next_launch``): {name: median ms over ``reps``
    calls}, their sum under "total".  It loses no event in a long window,
    where the profiler lost every window of K7 and K8 at 32k."""
    from repro_torch.kernels import _build
    fn()
    torch.cuda.synchronize()
    times = {n: [] for n in (*names, "total")}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        for e in ev:                     # each gets its handle
            e.record()
        torch.cuda.synchronize()
        _build.time_next_launch(ev)
        fn()
        got = _build.launch_events_recorded()
        if got != len(ev):
            raise AssertionError(f"kernel_split: the launcher recorded {got}"
                                 f" of {len(ev)} events for {names}")
        ev[-1].synchronize()
        for i, n in enumerate(names):
            times[n].append(ev[i].elapsed_time(ev[i + 1]))
        times["total"].append(ev[0].elapsed_time(ev[-1]))
    return {n: statistics.median(v) for n, v in times.items()}


K7_KERNELS = ("split", "combine")
K8_KERNELS = ("state", "pass", "output")


def phase_llm_kernel_split(torch, card, batches) -> dict:
    """K7 and K8 split by device kernel (:func:`kernel_split`), in bf16 and
    float32, at the dry run's 32k card shapes (``batches``: K7 over every
    slot of a 32k cache, K8 over 32k steps at zamba2's chunk) and at the
    serving shapes (zamba2's decode, 4 slots at 385-399 of 512; its
    384-token prefill).  Returns {"<kernel> <dtype> <shape>": split}."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ssd_scan as sk
    cfg = get_config(DRYRUN_ARCH)
    s32 = INPUT_SHAPES["prefill_32k"].seq_len
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p_, n_, hs = cfg.ssm_head_dim, cfg.ssm_state, cfg.n_ssm_heads
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "float32"
        for b, S, lens in ((batches["decode_32k"], s32, None),
                           (4, 512, [385, 390, 395, 399])):
            q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
            kc, vc = (torch.randn((b, S, kv, d), generator=gen,
                                  device="cuda").to(dtype) for _ in "kv")
            cl = torch.as_tensor(lens or [S] * b, dtype=torch.int32,
                                 device="cuda")
            key = f"K7 {tag} b={b} S={S} heads={h}/{kv} d={d}"
            out[key] = kernel_split(
                torch, lambda: da.decode_attention(q, kc, vc, cl), K7_KERNELS)
            del q, kc, vc
            torch.cuda.empty_cache()
        for b, s in ((batches["prefill_32k"], s32), (1, 384)):
            x = torch.randn((b, s, hs, p_), generator=gen,
                            device="cuda").to(dtype)
            dt = torch.rand((b, s, hs), generator=gen, device="cuda") * 0.1
            A = -torch.rand((hs,), generator=gen, device="cuda") - 0.5
            B, C = ((torch.randn((b, s, n_), generator=gen, device="cuda")
                     * 0.3).to(dtype) for _ in "BC")
            key = (f"K8 {tag} b={b} s={s} h={hs} p={p_} n={n_} "
                   f"chunk={cfg.ssm_chunk}")
            out[key] = kernel_split(
                torch, lambda: sk.ssd_scan(x, dt, A, B, C,
                                           chunk=cfg.ssm_chunk), K8_KERNELS)
            del x, dt, A, B, C
            torch.cuda.empty_cache()
    for key, split in out.items():
        print(f"split by device kernel, {key}: " + ", ".join(
            f"{n} {ms:.4f} ms" for n, ms in split.items())
            + f" (median of {SPLIT_REPS} calls, CUDA events the launcher "
              f"records between its kernels) [{card}]")
    return out


PARENT_PHASES = """
import sys
sys.path[:0] = [{script!r}, {src!r}]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch import set_reference_precision
set_reference_precision()
card = cs.card_line()
{calls}
"""
# the parent's phases that --parent runs before and after this tree's: the
# video kernels' (their device times matched by parent_key), then K6's,
# K7's and K8's (their lines relayed; --only k6 / k7 / k8 runs those named)
PARENT_VIDEO = ("phase_crop_gather", "phase_onevsall_update",
                "phase_region_filter", "phase_frame_filter",
                "phase_iou_matrix")
PARENT_LLM = {"k6": "phase_flash_attention", "k7": "phase_decode_attention",
              "k8": "phase_ssd_scan"}
# host-bound probes that --only runs in a process of their own, on this
# tree's package and with --parent on the parent's (they read only the
# package's entry points), by the start of their lines: a fresh process
# for each, so that the two trees' host times compare
PROBES = {"phase_k7_host": "K7 bf16 host",
          "phase_decode_step": "decode_32k step",
          "phase_gemma2_32k": "gemma2 32k",
          "phase_gemma2_serve": "gemma2 serve"}


def run_parent(root: str, phases, own: bool = False) -> str:
    """Run ``phases`` of another checkout (the parent commit, unpacked with
    ``git archive``) in a subprocess on this card; return its output.
    ``own``: this script's phases (each called with torch and card) on the
    other checkout's package, its ``src/`` first on the path."""
    code = PARENT_PHASES.format(
        script=ROOT if own else os.path.abspath(root),
        src=os.path.join(os.path.abspath(root), "src"),
        calls="\n".join(f"cs.{name}(torch, card)" if own
                        else f"cs.{name}(torch, np, card)"
                        for name in phases))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"the parent's {', '.join(phases)} failed:\n"
                           f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    return run.stdout


def relay_parent_llm(root: str, when: str, only=None) -> None:
    """The parent's K6, K7 and K8 rows (float32 and bf16), or those of
    ``only`` (names of PARENT_LLM), relayed."""
    phases = [p for n, p in PARENT_LLM.items() if only is None or n in only]
    for line in run_parent(root, phases).splitlines():
        if line.startswith(("K6", "K7", "K8")):
            print(f"  parent ({when} this tree's): {line}")


def relay_probes(root: str, label: str, probes) -> None:
    """This script's ``probes`` (of PROBES) on ``root``'s package, in a
    process of their own, their lines relayed under ``label``."""
    for line in run_parent(root, probes, own=True).splitlines():
        if line.startswith(tuple(PROBES.values())):
            print(f"  {label}: {line}")


def parent_key(tag: str, shape: str):
    """The key of a kernel row's parent time: K2 and K5 by their batch
    (``B=...``), K1, K4a and K4b by their whole shape."""
    return tag, (shape if tag in ("K1", "K4a", "K4b") else shape.split()[0])


def parent_device_ms(root: str, card: str):
    """Run the K2, K5, K1, K4b and K4a phases of another checkout (the
    parent commit, unpacked with ``git archive``) in a subprocess on this
    card; relay its lines and return {parent_key(...): device ms per
    call}."""
    import re
    found = {}
    for line in run_parent(root, PARENT_VIDEO).splitlines():
        m = re.match(r"(K[125]|K4[ab]) \w+ ((?:[A-Z]\w*=\d+)(?: [A-Z]\w*=\d+)*)"
                     r"[^:]*: .*?ms per call \((\d+\.\d+) ms on the device",
                     line)
        if m:
            print(f"  parent: {line}")
            found.setdefault(parent_key(m.group(1), m.group(2)),
                             float(m.group(3)))
    return found


# ---------------------------------------------------------------------------
# the LLM serving paths: full-width zamba2-7b (hybrid SSM) and
# deepseek-v2-lite-16b (MoE + MLA) behind LLMServer, full-width
# musicgen-medium (cross-attention over stub embeddings) through
# prefill / decode_step
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the dry run (launch/dryrun.py): every arch x shape counted on meta tensors,
# then zamba2-7b's prefill_32k and decode_32k steps on the card
# ---------------------------------------------------------------------------
DRYRUN_ARCH = "zamba2-7b"
DRYRUN_CARD_SHAPES = ("prefill_32k", "decode_32k")
DRYRUN_WORKERS = 8
DRYRUN_K6_REPS = 5            # timed calls of K6 at the bf16 32k shape
DRYRUN_K6_FP32_REPS = 3       # and of the float32 row at 2 x 32k (~0.46 s)
DRYRUN_REF_SEQ = 512          # the 9-layer cut's card-vs-CPU bf16 steps
DRYRUN_PEAK_RTOL = 0.005      # the card's peak against the abstract pass's
INT32_LIMIT = 2 ** 31


def _abstract_row(combo):
    """One (arch, shape) abstract pass, in a spawned worker process."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.dryrun import run_one
    return run_one(*combo, device="meta", verbose=False, save=False)


def phase_dryrun_table(card):
    """(a) The abstract pass of every arch x input shape, in a pool of
    spawned processes; one row each.  Returns {(arch, shape): row}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import INPUT_SHAPES, list_archs
    combos = [(a, s) for a in list_archs() for s in sorted(INPUT_SHAPES)]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=min(DRYRUN_WORKERS, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        rows = dict(zip(combos, pool.map(_abstract_row, combos)))
    for (arch, shape), r in rows.items():
        print(f"dryrun {arch} {shape}: {r['hlo_flops']:.4e} FLOP, "
              f"{r['hlo_bytes']:.4e} B, arguments {r['arg_bytes'] / 1e9:.2f}"
              f" GB, peak {r['peak_memory_per_device'] / 1e9:.2f} GB, fits "
              f"{r['fits']}, largest batch {r['max_batch']}, floor "
              f"{r['t_floor'] * 1e3:.3f} ms ({r['dominant']}), abstract "
              f"pass {r['t_abstract_s']:.1f} s [{card}]")
    print(f"dryrun: {len(rows)} abstract passes in "
          f"{time.perf_counter() - t0:.1f} s ({DRYRUN_WORKERS} workers) "
          f"[{card}]")
    return rows


def kernel_offsets(cfg, b_prefill: int, b_decode: int, seq: int) -> dict:
    """The largest element count each LLM kernel indexes at the dry run's
    card shapes (an operand, its output or its workspace; K8's only where
    ``cfg`` has Mamba2 layers)."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ssd_scan as sk
    h, d = cfg.num_heads, cfg.head_dim
    q, kc = (torch.empty((b_decode, h, d), device="meta"),
             torch.empty((b_decode, seq, cfg.num_kv_heads, d),
                         device="meta"))
    out = {"flash_attention": b_prefill * seq * h * d,
           "decode_attention": max(kc.numel(), da.workspace_bytes(
               q, kc, kc, None, da.H100_RESIDENT) // 4)}
    if cfg.ssm_state:
        x = torch.empty((b_prefill, seq, cfg.n_ssm_heads, cfg.ssm_head_dim),
                        device="meta")
        B = torch.empty((b_prefill, seq, cfg.ssm_state), device="meta")
        out["ssd_scan"] = max(x.numel(), sk.workspace_bytes(
            x, B, cfg.ssm_chunk) // 4)
    return out


def card_batches(table, arch: str = DRYRUN_ARCH) -> dict:
    """The batch of ``arch`` that its abstract pass in ``table`` picked at
    each card shape: the largest that fits the card."""
    return {s: table[(arch, s)]["max_batch"] for s in DRYRUN_CARD_SHAPES}


def phase_dryrun_card(torch, card, table, arch: str = DRYRUN_ARCH):
    """(b) ``dryrun.card_pass`` for ``arch`` at full width and depth, at
    the batch the table's abstract pass picked: launch counts zeroed just
    before the first timed step and read just after it; the prediction
    beside the measurement (a decode step's time the median of
    ``dryrun.DECODE_CALLS`` calls, with the fastest and slowest).  Returns
    {shape: the ``card`` dict}."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.dryrun import card_pass
    from repro_torch.launch.specs import arch_for_shape
    cfg = get_config(arch)
    batches = card_batches(table, arch)
    if not all(batches.values()):
        raise AssertionError(f"dryrun: no batch of {arch} fits at "
                             f"{batches}")
    for shape in sorted(INPUT_SHAPES):
        r = table[(arch, shape)]
        if not r["max_batch"]:
            print(f"dryrun: {arch} {shape} does not fit the card in "
                  f"{r['compute_dtype']} at any batch: "
                  f"{r['batch1_peak_bytes'] / 1e9:.2f}"
                  f" GB live at batch 1, {r['arg_bytes'] / 1e9:.2f} GB of "
                  f"arguments at batch {INPUT_SHAPES[shape].global_batch} "
                  f"[{card}]")
    offsets = kernel_offsets(cfg, batches["prefill_32k"],
                             batches["decode_32k"],
                             INPUT_SHAPES["prefill_32k"].seq_len)
    print(f"dryrun: largest element offsets at the card shapes {offsets}, "
          f"all below 2^31 = {INT32_LIMIT} [{card}]")
    if max(offsets.values()) >= INT32_LIMIT:
        raise AssertionError(f"dryrun: an offset reaches 2^31: {offsets}")
    # every launch of the bf16 steps is a bf16 one
    want = {shape: {**w, **{k + "_bf16": n for k, n in w.items()}}
            for shape, w in (("prefill_32k", path_launches(cfg, 1, 0)),
                             ("decode_32k", path_launches(cfg, 0, 1)))}
    out = {}
    for shape in DRYRUN_CARD_SHAPES:
        torch.cuda.empty_cache()
        full = INPUT_SHAPES[shape]
        c = card_pass(arch_for_shape(cfg, full), full, table[(arch, shape)])
        check_launches(c["launches"], want[shape], f"{arch}'s {shape} step")
        peak_ratio = c["peak_bytes"] / c["predicted_peak_bytes"]
        if not (c["finite"] and c["batch"] == batches[shape]
                and abs(peak_ratio - 1) <= DRYRUN_PEAK_RTOL):
            raise AssertionError(f"dryrun {shape}: finite {c['finite']}, "
                                 f"batch {c['batch']} of {batches[shape]}, "
                                 f"peak {peak_ratio:.4f} of the prediction")
        print(f"dryrun on the card: {arch} {shape} at batch "
              f"{c['batch']} of {INPUT_SHAPES[shape].global_batch}: "
              f"{c['ms']:.3f} ms (median of {c['calls']} calls, "
              f"{c['ms_min']:.3f}-{c['ms_max']:.3f}) against a floor of "
              f"{c['floor_ms']:.3f} ms ({c['dominant']}; "
              f"{c['over_floor']:.3f}x the floor); peak "
              f"{c['peak_bytes'] / 1e9:.3f} GB measured against "
              f"{c['predicted_peak_bytes'] / 1e9:.3f} GB predicted "
              f"({c['peak_bytes'] / c['predicted_peak_bytes']:.4f}); "
              f"launches {c['launches']} [{card}]")
        c["offsets"] = offsets
        out[shape] = c
    return out


def phase_dryrun_kernels(torch, np, card, batches):
    """(c) K6, K7 and K8 at the dry run's 32k card shapes and batches on
    bf16 operands, the steps' own, against their plain versions (K6 on
    256-query slices at the head and tail: its plain version over all 32k
    queries would hold 137 GB of scores a row; K8 row by row: its plain
    version's s x s decay tensors over six rows pass 80 GB, so its plain
    time is not measured there), timed with their bf16 bounds
    and SDPA's bf16 time where it computes the same function (K6 over
    DRYRUN_K6_REPS calls).  Then the float32 K6 row at 2 x 32k, the shape
    ROADMAP queue 2 tracks against SDPA.  Returns {kernel name: row}, the
    float32 row under "flash_attention_fp32"."""
    import torch.nn.functional as F

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.testing import (ATTN_ATOL, ATTN_BF16_RTOL,
                                     SSD_BF16_RTOL, SSD_RTOL, rel_err)
    cfg = get_config(DRYRUN_ARCH)
    s = INPUT_SHAPES["prefill_32k"].seq_len
    bp, bd = batches["prefill_32k"], batches["decode_32k"]
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    rows = {}

    def k6(b, dtype, reps):
        q, k, v = (randn(b, s, n, d, dtype=dtype) for n in (h, kv, kv))
        got = fa.flash_attention(q, k, v)
        err = (0.0, 0.0)
        for lo in (0, s - 256):
            want = fa.flash_attention_ref(q[:, lo:lo + 256], k, v,
                                          q_offset=lo)
            e = bf16_err(got[:, lo:lo + 256], want)
            err = (max(err[0], e[0]), max(err[1], e[1]))
        del want
        # bf16 against its scale (a rounding of the output), float32
        # absolutely, as the f32 rows
        tol = ATTN_BF16_RTOL if dtype == bf16 else ATTN_ATOL
        gate = err[1] if dtype == bf16 else err[0]
        if not (gate <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K6 {dtype} at {b} x {s}: error {err}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        timed, lib, turns = versus_library(
            torch, lambda: fa.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=h != kv), reps,
            once=True)
        pairs = b * s * (s + 1) // 2
        size = 2 if dtype == bf16 else 4
        nbytes = size * b * s * (h + kv) * 2 * d + 4 * b
        shape = f"b={b} s_q={s} s_kv={s} heads={h}/{kv} d={d} causal"
        if dtype == bf16:
            row = _bf16_row(
                "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:86", shape, err, timed,
                (None, None), lib[0], bf16_bound_ms(
                    nbytes, pairs * h * 2 * (d + d),
                    pairs * h * (_attn_ops_per_pair(d, None, d)
                                 - 2 * (d + d))), tol)
        else:
            row = _row("flash_attention",
                       "src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:86", shape,
                       err[0], timed, (None, None), lib[0], nbytes,
                       pairs * h * _attn_ops_per_pair(d, None, d))
            row["bound_tc_ms"], row["bound_tc_by"] = flash_tc_bound(
                nbytes, pairs * h, d, d, None)
        row.update(library_device_ms=lib[1], turns_ms=turns,
                   kernel=k6_instance(fa, b, s, h, d, d, dtype))
        return row

    rows["flash_attention"] = k6(bp, bf16, DRYRUN_K6_REPS)
    torch.cuda.empty_cache()
    # K8: the prefill's scan at the model's chunk, x, B and C bf16
    p_, n_, hs = cfg.ssm_head_dim, cfg.ssm_state, cfg.n_ssm_heads
    x, dt = randn(bp, s, hs, p_), torch.rand(
        (bp, s, hs), generator=gen, device="cuda") * 0.1
    A = -torch.rand((hs,), generator=gen, device="cuda") - 0.5
    B, C = randn(bp, s, n_, scale=0.3), randn(bp, s, n_, scale=0.3)
    kw = dict(chunk=cfg.ssm_chunk)
    y, fin = sk.ssd_scan(x, dt, A, B, C, **kw)
    err, fin_err, t0 = (0.0, 0.0), 0.0, time.perf_counter()
    for r in range(bp):
        y_ref, fin_ref = sk.ssd_scan_ref(x[r:r + 1], dt[r:r + 1], A,
                                         B[r:r + 1], C[r:r + 1], **kw)
        e = bf16_err(y[r:r + 1], y_ref)
        err = (max(err[0], e[0]), max(err[1], e[1]))
        fin_err = max(fin_err, rel_err(fin[r:r + 1].cpu(), fin_ref.cpu()))
        del y_ref, fin_ref
    ref_s = time.perf_counter() - t0
    if not (err[1] <= SSD_BF16_RTOL and fin_err <= SSD_RTOL
            and bool(torch.isfinite(y).all())):
        raise AssertionError(f"K8 bf16 at {bp} x {s}: error {err}, final "
                             f"state {fin_err}")
    timed = measure(torch, lambda: sk.ssd_scan(x, dt, A, B, C, **kw),
                    once=True)
    nbytes = ssd_nbytes(bp, s, hs, p_, n_, False, size=2)
    row = _bf16_row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                    "src/repro/kernels/ssd_scan.py:74",
                    f"b={bp} s={s} h={hs} p={p_} n={n_} "
                    f"chunk={cfg.ssm_chunk} (error row by row)", err, timed,
                    (None, None), None,
                    bound_ms(nbytes, ssd_ops(bp, s, hs, p_, n_)),
                    SSD_BF16_RTOL)
    # C B^T at bf16's rate, the other products as two TF32 ones
    row["bound_tc_ms"], row["bound_tc_by"] = tc_bound_ms(
        nbytes, *ssd_tc_ops(bp, s, hs, p_, n_, cfg.ssm_chunk, bf16=True))
    row.update(final_state_err=fin_err, reference_s=ref_s,
               kernel=", ".join(k8_instances(sk, p_, n_, bf16)))
    rows["ssd_scan"] = row
    del x, dt, A, B, C, y, fin
    torch.cuda.empty_cache()
    # K7: one token over every slot of a 32k bf16 cache
    q, kc, vc = randn(bd, h, d), randn(bd, s, kv, d), randn(bd, s, kv, d)
    cl = torch.full((bd,), s, dtype=torch.int32, device="cuda")
    got = da.decode_attention(q, kc, vc, cl)
    err = bf16_err(got, da.decode_attention_ref(q, kc, vc, cl))
    if not (err[1] <= ATTN_BF16_RTOL and bool(torch.isfinite(got).all())):
        raise AssertionError(f"K7 bf16 at {bd} x {s}: error {err}")
    # the plain version before its rounding to bf16 (a float32 q)
    steps = bf16_steps(torch, got, da.decode_attention_ref(q.float(), kc,
                                                           vc, cl))
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    timed, lib, turns = versus_library(
        torch, lambda: da.decode_attention(q, kc, vc, cl),
        lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                               enable_gqa=h != kv),
        once=True)
    del kt, vt
    plain = measure(torch, lambda: da.decode_attention_ref(q, kc, vc, cl))
    row = _bf16_row("decode_attention",
                    "src/repro_torch/csrc/decode_attention.cu",
                    "src/repro/kernels/decode_attention.py:73",
                    f"b={bd} S={s} heads={h}/{kv} d={d} lens={s}", err,
                    timed, plain, lib[0], bf16_bound_ms(
                        decode_nbytes(bd, h, kv, d, [s] * bd, s, None,
                                      size=2),
                        bd * s * h * 4 * d,
                        bd * s * h * (_attn_ops_per_pair(d, None) - 4 * d)),
                    ATTN_BF16_RTOL)
    row.update(library_device_ms=lib[1], turns_ms=turns,
               kernel=k7_instance(da, q, kc, vc), **steps)
    rows["decode_attention"] = row
    del q, kc, vc, got
    torch.cuda.empty_cache()
    for name, row in rows.items():
        tc = ("" if "bound_tc_ms" not in row else
              f", tensor-core bound {row['bound_tc_ms']:.6f} ms")
        if "final_state_err" in row:
            tc += (f", final state {row['final_state_err']:.3e} (tolerance "
                   f"{SSD_RTOL}), plain versions {row['reference_s']:.1f} s")
        if "steps" in row:
            tc += (f", bf16 steps from the float32 plain version rounded "
                   f"{row['steps']}, largest {row['max_ulps']:.3f} ulps")
        kernel = f", {row['kernel']}" if "kernel" in row else ""
        _bf16_report(f"dryrun kernel {name} bf16 {row['shape']}{kernel}{tc}",
                     row, card)
        if "turns_ms" in row:
            _report_turns(f"dryrun kernel {name} bf16 {row['shape']}",
                          row["turns_ms"], row, "sdpa bf16", card)
    fp32 = k6(2, torch.float32, DRYRUN_K6_FP32_REPS)
    torch.cuda.empty_cache()
    _report(f"dryrun kernel flash_attention float32 {fp32['shape']}, "
            f"{fp32['kernel']}: error {fp32['max_abs_err']:.3e}, tensor-core "
            f"bound {fp32['bound_tc_ms']:.6f} ms", fp32, card, "sdpa")
    _report_turns(f"dryrun kernel flash_attention float32 {fp32['shape']}",
                  fp32["turns_ms"], fp32, "sdpa", card)
    rows["flash_attention_fp32"] = fp32
    return rows


def phase_dryrun_reference(torch, np, card, arch: str = DRYRUN_ARCH):
    """(d) The prefill and decode steps of ``launch.specs.make_step``, in
    bf16, on ``arch`` cut to one block (zamba2-7b: 9 layers; gemma2-9b: a
    LOCAL and a global layer), the same bf16 weights on the card and the
    CPU: a 1 x DRYRUN_REF_SEQ prefill, then one decode step over
    its cache (rewriting its last slot).  Each layer the card applies is
    held to the CPU's on the CPU's own inputs (``testing.LayerTap``:
    BF16_LLM_RTOL of its output's and its cache's scale); the logits end
    to end are printed beside them (bf16 noise grows through a model, so
    they are not gated) and must be finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models import schema as sch
    from repro_torch.models import transformer as tfm
    from repro_torch.testing import (BF16_LLM_RTOL, LayerTap, rel_err,
                                     replay_layers)
    cfg = block_cut(get_config(arch), 1)
    s = DRYRUN_REF_SEQ
    prefill = specs.make_step(cfg, ShapeConfig("p", s, 1, "prefill"))[0]
    decode = specs.make_step(cfg, ShapeConfig("d", s, 1, "decode"))[0]
    params = {"cuda": tfm.init_params(cfg, SEED, "cuda",
                                      specs.COMPUTE_DTYPE)}
    params["cpu"] = sch.tree_map(lambda t: t.cpu(), params["cuda"])
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, s))
    out, counts, taps, wall = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        t = torch.as_tensor(toks, device=dev)
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        with LayerTap() as taps[dev, "prefill"]:
            logits, cache = prefill(params[dev], t)
        counts[dev, "prefill"] = ops.launch_counts()
        ops.reset_launch_counts()
        with LayerTap() as taps[dev, "decode"]:
            step, _ = decode(params[dev], t[:, -1:], cache,
                             torch.tensor(s - 1, device=dev))
        counts[dev, "decode"] = ops.launch_counts()
        out[dev] = (logits.float().cpu().numpy(),
                    step[:, 0].float().cpu().numpy())
        wall[dev] = time.perf_counter() - t0
    check_launches(counts["cuda", "prefill"], path_launches(cfg, 1, 0),
                   f"{cfg.name}'s prefill step")
    check_launches(counts["cuda", "decode"], path_launches(cfg, 0, 1),
                   f"{cfg.name}'s decode step")
    layer_errs = {}
    for what in ("prefill", "decode"):
        layer_errs[what] = replay_layers(cfg, taps["cpu", what].calls,
                                         "cuda")
        worst = max(max(e, c) for _, e, c in layer_errs[what])
        if not worst <= BF16_LLM_RTOL:
            raise AssertionError(f"dryrun {what} layers card vs CPU: "
                                 f"{layer_errs[what]}")
    del taps
    errs = [rel_err(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    if not all(np.isfinite(o).all() for o in out["cuda"]):
        raise AssertionError("dryrun steps: non-finite logits on the card")
    worst = {w: max(max(e, c) for _, e, c in v)
             for w, v in layer_errs.items()}
    card_s, cpu_s = wall["cuda"], wall["cpu"]
    print(f"dryrun steps card vs CPU in bf16, {cfg.name} at full width, 1 x "
          f"{s}: every layer within {worst['prefill']:.3e} (prefill) and "
          f"{worst['decode']:.3e} (decode) of its scale on the CPU's inputs "
          f"(tolerance {BF16_LLM_RTOL}); end to end the logits "
          f"{errs[0]:.3e} (prefill) and {errs[1]:.3e} (decode) apart (not "
          f"gated); steps {card_s:.2f} s on the card, {cpu_s:.2f} s on the "
          f"CPU [{card}]")
    del params
    torch.cuda.empty_cache()
    return {"prefill_layers": worst["prefill"],
            "decode_layers": worst["decode"], "prefill_logits": errs[0],
            "decode_logits": errs[1], "cpu_s": cpu_s}


def busy_us(spans) -> float:
    """The time the union of sorted (start, end, ...) spans covers."""
    busy, reach = 0.0, None
    for start, end, *_ in spans:
        lo = start if reach is None else max(start, reach)
        busy += max(0.0, end - lo)
        reach = end if reach is None else max(reach, end)
    return busy


K7_HOST_CALLS = 1000       # calls a K7 host-time window
DECODE_TRACE_CALLS = 3     # decode_32k steps traced, one window each


def phase_k7_host(torch, card) -> dict:
    """Host microseconds to issue one bf16 K7 call at zamba2's decode shape
    (4 x 512 slots, 399 valid, 32/32 heads, d 112; :func:`host_us`, the
    card idle behind it): the wrapper's checks, its split plan, the
    workspace and the launch.  Where the package caches its plan
    (``decode_attention.plan``), also with the caches cleared before each
    call (the wrapper's per-call work without them), the two in turns.
    Reads only the package's entry points, so --parent runs it on the
    parent's.  Returns {variant: [turn times]}."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, kc, vc = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((4, 32, 112), (4, 512, 32, 112),
                                      (4, 512, 32, 112)))
    cl = torch.full((4,), 399, dtype=torch.int32, device="cuda")
    fns = {"as is": lambda: da.decode_attention(q, kc, vc, cl)}
    if hasattr(da, "plan"):
        def cleared():
            da.splits.cache_clear()
            da.resident_blocks.cache_clear()
            return da.decode_attention(q, kc, vc, cl)
        fns["caches cleared"] = cleared
    turns = in_turns(fns, lambda fn: host_us(torch, fn, K7_HOST_CALLS))
    print("K7 bf16 host time per call at 4 x 512, d 112: " + "; ".join(
        f"{name} " + ", ".join(f"{us:.2f}" for us in t) + " us"
        for name, t in turns.items())
        + f" (turns of {K7_HOST_CALLS} calls) [{card}]")
    return turns


GEMMA_ARCH = "gemma2-9b"
GEMMA_K6_REPS = 3          # timed calls of a K6 case at 32k (on the CUDA
                           # cores a global layer's call took seconds)


def gemma2_32k_cases(cfg, batches):
    """gemma2-9b's K6 and K7 calls at the dry run's 32k card shapes
    (``batches``: prefill_32k's rows, decode_32k's slots): one global
    layer's and one LOCAL layer's (its sliding window), each with the
    attention softcap: [(kernel, layer, batch, window)]."""
    return [(kernel, layer, batches[shape], window)
            for kernel, shape in (("K6", "prefill_32k"), ("K7", "decode_32k"))
            for layer, window in (("global", None),
                                  ("LOCAL", cfg.sliding_window))]


def gemma2_bound(cfg, kernel, b, s, window):
    """(bytes, bf16 products, other operations, :func:`bf16_bound_ms`) of
    one of gemma2's K6 (b x s causal, queries at positions 0 .. s - 1) or
    K7 (b slots over s valid slots) calls: q, the output and every K and V
    row some query reads once, in bf16; every (query head, key) pair the
    mask lets through."""
    from repro_torch.kernels.flash_attention import causal_pairs
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if kernel == "K6":
        pairs = b * h * causal_pairs(s, s, causal=True, window=window,
                                     q_offset=0)
        nbytes = 2 * (b * s * h * 2 * d + b * s * kv * 2 * d) + 4 * b
    else:
        pairs = h * decode_rows([s] * b, s, window)
        nbytes = decode_nbytes(b, h, kv, d, [s] * b, s, window, size=2)
    mma = pairs * 4 * d
    other = pairs * (_attn_ops_per_pair(d, cfg.attn_logit_softcap) - 4 * d)
    return nbytes, mma, other, bf16_bound_ms(nbytes, mma, other)


def phase_gemma2_32k(torch, card, batches=None, check=False) -> dict:
    """K6 and K7 on bf16 operands at gemma2-9b's 32k card shapes
    (:func:`gemma2_32k_cases`; the batches its abstract passes pick where
    None): each timed by CUDA events in turns with SDPA's bf16 at the same
    shape without the softcap and the window (K and V repeated to the
    q-heads) -- not the same function: no single PyTorch call computes
    attention with a softcap -- beside its bf16 bound, and its device time
    (K6's one kernel from the profiler; K7's two from the events its
    launcher records, :func:`kernel_split`), since a call's time also
    holds the host's launch path.  Reads only the package's entry points,
    so --parent runs it on the parent's package.
    With ``check`` (the dry run's phase (c) for gemma2) each result is
    first held against its plain version on the same operands, as
    :func:`phase_dryrun_kernels` holds zamba2's (K6 on 256-query slices at
    the head and the tail), and the row names its kernel instance.
    Returns {"<kernel> <layer>": figures}."""
    import torch.nn.functional as F

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.testing import ATTN_BF16_RTOL
    cfg = get_config(GEMMA_ARCH)
    if batches is None:
        from repro_torch.launch.dryrun import run_one
        batches = {shape: run_one(GEMMA_ARCH, shape, device="meta",
                                  verbose=False, save=False)["max_batch"]
                   for shape in DRYRUN_CARD_SHAPES}
    s = INPUT_SHAPES["prefill_32k"].seq_len
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cap, bf16 = cfg.attn_logit_softcap, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def heads(t):                        # (b, s, kv, d) -> (b, h, s, d)
        return t.repeat_interleave(h // kv, 2).transpose(1, 2).contiguous()

    out = {}
    for kernel, layer, b, window in gemma2_32k_cases(cfg, batches):
        torch.cuda.empty_cache()
        row = {}
        if kernel == "K6":
            q, k, v = randn(b, s, h, d), randn(b, s, kv, d), randn(b, s, kv,
                                                                    d)
            fn = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, window=window, softcap=cap)
            qt, kt, vt = q.transpose(1, 2).contiguous(), heads(k), heads(v)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True)
            reps, warmup = GEMMA_K6_REPS, 1
            route = ("wgmma" if fa.on_tensor_cores(d, d, bf16)
                     else "CUDA cores")
            shape = f"b={b} s_q={s} s_kv={s} heads={h}/{kv} d={d} causal"
            if check:
                got, err = fn(), (0.0, 0.0)
                for lo in (0, max(0, s - 256)):
                    e = bf16_err(got[:, lo:lo + 256], fa.flash_attention_ref(
                        q[:, lo:lo + 256], k, v, window=window, softcap=cap,
                        q_offset=lo))
                    err = (max(err[0], e[0]), max(err[1], e[1]))
                row["kernel"] = k6_instance(fa, b, s, h, d, d, bf16)
        else:
            q, k, v = randn(b, h, d), randn(b, s, kv, d), randn(b, s, kv, d)
            cl = torch.full((b,), s, dtype=torch.int32, device="cuda")
            fn = lambda: da.decode_attention(  # noqa: E731
                q, k, v, cl, window=window, softcap=cap)
            qt, kt, vt = q[:, :, None], heads(k), heads(v)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt)
            reps, warmup = 30, 5
            route = "TMA" if da.on_tma(q, k, v) else "split"
            shape = f"b={b} S={s} heads={h}/{kv} d={d} lens={s}"
            if check:
                got = fn()
                err = bf16_err(got, da.decode_attention_ref(
                    q, k, v, cl, window=window, softcap=cap))
                row["kernel"] = k7_instance(da, q, k, v)
        if check:
            if not (err[1] <= ATTN_BF16_RTOL
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"gemma2 {kernel} bf16 {layer} at "
                                     f"{shape}: error {err}")
            row.update(max_abs_err=err[0], rel_err=err[1],
                       tolerance=ATTN_BF16_RTOL)
            del got
        nbytes, mma, other, (bound, by) = gemma2_bound(cfg, kernel, b, s,
                                                       window)
        turns = in_turns({"kernel": fn, "library": lib},
                         lambda f: time_ms(torch, f, reps, warmup))
        if kernel == "K6":
            device = profile_device(torch, fn, 1, once=True)[0]
        else:
            row["split_ms"] = kernel_split(torch, fn, K7_KERNELS)
            device = row["split_ms"]["total"]
        row.update(shape=shape, window=window, softcap=cap, route=route,
                   ms=statistics.mean(turns["kernel"]), turns_ms=turns,
                   device_ms=device, bound_ms=bound, bound_by=by,
                   bytes=nbytes, bf16_products=mma, other_ops=other)
        out[f"{kernel} {layer}"] = row
        checked = ("" if not check else
                   f", {row['kernel']}: error {row['max_abs_err']:.3e} "
                   f"({row['rel_err']:.3e} of its row's largest value; "
                   f"tolerance {ATTN_BF16_RTOL:.3e})")
        print(f"gemma2 32k {kernel} bf16 {layer} layer ({shape} window "
              f"{window} softcap {cap}) on the {route} kernel{checked}: "
              + ", ".join(f"{t:.4f}" for t in turns["kernel"])
              + " ms per call in turns with SDPA's bf16 without the softcap"
              " and window (not the same function) "
              + ", ".join(f"{t:.4f}" for t in turns["library"])
              + f" ms; the kernel {fmt(device)} on the device; bound "
              f"{bound:.6f} ms ({by}; {nbytes:.4e} B, "
              f"{mma:.4e} bf16 products, {other:.4e} other) [{card}]")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def phase_decode_step(torch, card, row=None) -> dict:
    """DRYRUN_ARCH's decode_32k step on the card at the batch its abstract
    pass (``row``, run here where None) picks, made as ``dryrun.card_pass``
    makes it: ``dryrun.DECODE_CALLS`` calls, each from an idle card, timed
    by CUDA events beside the host's time to issue it; then
    DECODE_TRACE_CALLS calls, each in a profiler window of its own: the
    device's busy time (the union of its kernels' spans), its share of
    the untraced median (the rest is the card idle, waiting for the host),
    and K7's kernels' time.  Reads only ``launch.dryrun``'s entry points,
    so --parent runs it on the parent's package.  Returns the figures."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import arch_for_shape
    full = INPUT_SHAPES["decode_32k"]
    if row is None:
        row = dryrun.run_one(DRYRUN_ARCH, "decode_32k", device="meta",
                             verbose=False, save=False)
    cfg = arch_for_shape(get_config(DRYRUN_ARCH), full)
    shape = dataclasses.replace(full, global_batch=row["max_batch"])
    torch.cuda.empty_cache()
    real = dryrun.step_inputs(cfg, shape, torch.device("cuda"))
    fn = dryrun.make_step(cfg, shape)[0]
    fn(*real)                                 # warm-up
    host, dev = [], []
    for _ in range(dryrun.DECODE_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn(*real)
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        dev.append(start.elapsed_time(end))
    median = statistics.median(dev)
    traced = []
    for _ in range(DECODE_TRACE_CALLS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*real)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        k7 = [sp for sp in spans if any(
            k in sp[2] for k in ("decode_tma_kernel", "decode_split_kernel",
                                 "decode_combine_kernel"))]
        traced.append({"kernels": len(spans),
                       "busy_ms": busy_us(spans) / 1e3,
                       "span_ms": ((spans[-1][1] - spans[0][0]) / 1e3
                                   if spans else 0.0),
                       "k7_ms": busy_us(k7) / 1e3})
    del real
    torch.cuda.empty_cache()
    busy = statistics.median(t["busy_ms"] for t in traced)
    out = {"batch": shape.global_batch, "ms": median, "ms_all": dev,
           "host_ms": statistics.median(host), "traced": traced,
           "busy_ms": busy, "idle_share": 1 - busy / median}
    print(f"decode_32k step of {DRYRUN_ARCH} at batch {shape.global_batch}: "
          f"{median:.3f} ms (median of {len(dev)} calls, "
          f"{min(dev):.3f}-{max(dev):.3f}), the host issues a call in "
          f"{out['host_ms']:.3f} ms (median); traced calls "
          + "; ".join(f"{t['kernels']} kernels, busy {t['busy_ms']:.3f} ms "
                      f"of a {t['span_ms']:.3f} ms span, K7 "
                      f"{t['k7_ms']:.3f} ms" for t in traced)
          + f"; the card busy {busy:.3f} ms of the median, idle "
          f"{out['idle_share']:.1%} [{card}]")
    return out


def phase_dryrun(torch, np, card):
    """The dry run's phases (a)-(d), for DRYRUN_ARCH and then GEMMA_ARCH
    (its steps, K6 and K7 at its 32k shapes, its one-block cut); returns
    what the JSON line carries."""
    table = phase_dryrun_table(card)
    runs = phase_dryrun_card(torch, card, table)
    runs["decode_32k"]["trace"] = phase_decode_step(
        torch, card, table[(DRYRUN_ARCH, "decode_32k")])
    batches = {s: runs[s]["batch"] for s in DRYRUN_CARD_SHAPES}
    kernels = phase_dryrun_kernels(torch, np, card, batches)
    kernels["split"] = phase_llm_kernel_split(torch, card, batches)
    steps = phase_dryrun_reference(torch, np, card)
    gemma = phase_dryrun_card(torch, card, table, GEMMA_ARCH)
    kernels["gemma2"] = phase_gemma2_32k(
        torch, card, {s: gemma[s]["batch"] for s in DRYRUN_CARD_SHAPES},
        check=True)
    gemma_steps = phase_dryrun_reference(torch, np, card, GEMMA_ARCH)
    keep = ("hlo_flops", "hlo_bytes", "arg_bytes", "peak_memory_per_device",
            "fits", "max_batch", "batch1_peak_bytes", "t_floor", "dominant",
            "kernel_plain_flops", "cut_t_floor", "t_abstract_s")
    return {"table": [dict(arch=a, shape=s, **{k: r[k] for k in keep})
                      for (a, s), r in table.items()],
            "card": runs, "kernels": kernels, "card_vs_cpu": steps,
            "card_gemma2": gemma, "card_vs_cpu_gemma2": gemma_steps}


LLM_ARCH = "zamba2-7b"
MOE_ARCH = "deepseek-v2-lite-16b"
CROSS_ARCH = "musicgen-medium"
LLM_SLOTS, LLM_MAX_SEQ, LLM_REQUESTS, LLM_PROMPT, LLM_NEW = 4, 512, 8, 384, 16
ATTN_KINDS = ("attn", "local", "moe", "cross", "shared_attn")


class StepTimer:
    """Wall time of each prefill and decode step the server makes, read by
    wrapping the two functions it calls (a synchronise before and after,
    where the server synchronises anyway to read its tokens)."""

    def __init__(self, torch, tfm):
        self.torch, self.tfm, self.times = torch, tfm, {}
        self.orig = {n: getattr(tfm, n) for n in ("prefill", "decode_step")}

    def __enter__(self):
        for name, fn in self.orig.items():
            self.times[name] = []
            setattr(self.tfm, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.times[name].append(time.perf_counter() - t0)
            return out
        return timed

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.tfm, name, fn)
        return False


def llm_requests(np, cfg, n, prompt_len, max_new, seed=0):
    from repro_torch.serving.server import Request
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, prompt_len),
                    max_new_tokens=max_new) for i in range(n)]


def layer_kinds(cfg):
    return (list(cfg.prefix_layers) + list(cfg.block_pattern)
            * cfg.num_blocks + list(cfg.suffix_layers))


def llm_kernel_calls(cfg):
    """(K6, K8) launches of one forward or prefill: a flash attention per
    attention-bearing layer (MLA's included) and one more per
    cross-attention layer, an SSD scan per Mamba2 layer."""
    kinds = layer_kinds(cfg)
    return (sum(k in ATTN_KINDS for k in kinds) + kinds.count("cross"),
            sum(k in ("ssm", "ssm_ffn") for k in kinds))


def decode_kernel_calls(cfg):
    """(K6, K7) launches of one decode step: a flash attention per
    cross-attention layer (over the context tokens), a decode attention per
    GQA self-attention layer (MLA decodes by its absorbed einsum, which is
    no kernel in the reference either)."""
    kinds = layer_kinds(cfg)
    return (kinds.count("cross"),
            0 if cfg.mla else sum(k in ATTN_KINDS for k in kinds))


def path_launches(cfg, prefills: int, steps: int):
    """The K6, K7 and K8 launches ``prefills`` prefills and ``steps`` decode
    steps of ``cfg`` make."""
    (k6, k8), (d6, d7) = llm_kernel_calls(cfg), decode_kernel_calls(cfg)
    return {"flash_attention": k6 * prefills + d6 * steps,
            "decode_attention": d7 * steps, "ssd_scan": k8 * prefills}


def check_launches(counts, want, what: str):
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{what} launched {name} {counts[name]} "
                                 f"times, expected {n}")


def draw_full_width(torch, card, cfg):
    """``cfg``'s parameters drawn on the card from SEED (nothing on the
    host)."""
    from repro_torch.models import schema as sch
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    nbytes = sch.param_bytes(tfm.model_schema(cfg))
    print(f"{cfg.name} at full width: {nbytes / 4e9:.3f} B parameters, "
          f"{nbytes / 1e9:.2f} GB float32, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return params


def phase_llm_main_path(torch, np, card, arch=LLM_ARCH):
    """``arch`` at full width behind ``LLMServer``: LLM_REQUESTS prompts
    through LLM_SLOTS slots, launch counts zeroed just before and read just
    after; returns (counts, cfg, params, figures): prefill and decode ms
    (medians), tokens/s, wall s and profile_llm's traced (wall, busy) ms."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.server import LLMServer
    cfg = get_config(arch)
    params = draw_full_width(torch, card, cfg)
    # warm-up: one request through the same server shape (allocator)
    warm = LLMServer(cfg, params, num_slots=LLM_SLOTS, max_seq=LLM_MAX_SEQ,
                     eos_token=-1)
    for req in llm_requests(np, cfg, 1, LLM_PROMPT, 3, seed=99):
        warm.submit(req)
    warm.run_until_drained()
    del warm

    server = LLMServer(cfg, params, num_slots=LLM_SLOTS, max_seq=LLM_MAX_SEQ,
                       eos_token=-1)
    for req in llm_requests(np, cfg, LLM_REQUESTS, LLM_PROMPT, LLM_NEW):
        server.submit(req)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with StepTimer(torch, tfm) as timer:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        finished = server.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    prefills = len(timer.times["prefill"])
    steps = len(timer.times["decode_step"])
    if len(finished) != LLM_REQUESTS or prefills != LLM_REQUESTS:
        raise AssertionError(f"served {len(finished)} of {LLM_REQUESTS} "
                             f"requests with {prefills} prefills")
    for req in finished:
        if (len(req.output) != LLM_NEW
                or not all(0 <= t < cfg.padded_vocab for t in req.output)
                or not 0.0 < req.confidence <= 1.0):
            raise AssertionError(f"request {req.request_id}: {req.output} "
                                 f"confidence {req.confidence}")
    want = path_launches(cfg, prefills, steps)
    check_launches(counts, want, f"{arch}'s LLM path")
    tokens = sum(len(r.output) for r in finished)
    pre, dec = timer.times["prefill"], timer.times["decode_step"]
    print(f"LLM main path: {arch} full width, {LLM_SLOTS} slots, "
          f"max_seq {LLM_MAX_SEQ}, {LLM_REQUESTS} requests x {LLM_PROMPT}"
          f"-token prompts x {LLM_NEW} new tokens: {wall:.3f} s wall, "
          f"{tokens} tokens, {tokens / wall:.2f} tokens/s; prefill "
          f"{statistics.median(pre) * 1e3:.2f} ms per request (median of "
          f"{prefills}, min {min(pre) * 1e3:.2f}), decode "
          f"{statistics.median(dec) * 1e3:.2f} ms per step (median of "
          f"{steps}, min {min(dec) * 1e3:.2f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{ {k: counts[k] for k in want} } [{card}]")
    figures = dict(
        prefill_ms=statistics.median(pre) * 1e3,
        decode_ms=statistics.median(dec) * 1e3, tokens_per_s=tokens / wall,
        wall_s=wall, profile=profile_llm(torch, np, card, cfg, params))
    del server
    torch.cuda.empty_cache()
    return counts, cfg, params, figures


def profile_llm(torch, np, card, cfg, params, ctx=None) -> dict:
    """Where one prefill and one 4-slot decode step spend the card's time
    (their wall time is inflated by the tracing; the shares count).  A ctx
    config takes ``ctx`` (LLM_SLOTS rows; the prefill the first).  Returns
    {"prefill" / "decode step": (traced wall ms, device busy ms)}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tfm
    from repro_torch.serving.kv_cache import CachePool
    pool = CachePool(cfg, LLM_SLOTS, LLM_MAX_SEQ, "cuda")
    toks = torch.as_tensor(llm_requests(np, cfg, 1, LLM_PROMPT, 1)[0].prompt,
                           device="cuda")[None]
    last = torch.zeros((LLM_SLOTS, 1), dtype=torch.long, device="cuda")
    idx = torch.full((LLM_SLOTS,), LLM_PROMPT, device="cuda")
    first = None if ctx is None else ctx[:1]
    out = {}
    for what, fn in (
            ("prefill", lambda: tfm.prefill(
                cfg, params, toks, tfm.init_cache(cfg, 1, LLM_MAX_SEQ,
                                                  "cuda"), ctx_embed=first)),
            ("decode step", lambda: tfm.decode_step(
                cfg, params, last, pool.cache, idx, ctx_embed=ctx))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        avgs = prof.key_averages()
        busy = sum(_self_device_us(e) for e in avgs) / 1e3
        top = sorted(avgs, key=_self_device_us, reverse=True)[:8]
        print(f"{cfg.name} {what} under the profiler: {wall * 1e3:.1f} ms "
              f"wall, device busy {busy:.2f} ms ({busy / (wall * 1e3):.1%}), "
              f"{sum(e.count for e in avgs if _self_device_us(e) > 0)} device "
              f"kernels/copies [{card}]")
        print("  top device time: " + "; ".join(
            f"{e.key[:48]} {_self_device_us(e) / 1e3:.3f} ms x{e.count}"
            for e in top))
        out[what] = (wall * 1e3, busy)
    return out


def llm_reference(torch, np, card, cfg, ctx=None):
    """``cfg`` (a cut of a full-width config), the same weights on the card
    and on the CPU: prefill logits of four 40-token prompts, one by one into
    a 4-slot pool, then six teacher-forced lockstep decode steps with
    per-slot cache indices, the server's calls.  Logits agree within
    LLM_RTOL and greedy tokens are equal except at top-2 ties.  With MoE
    layers a row may differ where the routers of its call hold a near-tie
    (testing.ROUTER_TIE): the card and the CPU can route a token apart
    there, and at decode the capacity couples the slots.  Such rows are
    exempt, counted and printed, and the CPU then continues from the card's
    cache.  ``ctx``: a ctx config's (4, n_ctx, ctx_dim) embeddings."""
    from repro_torch.models import schema as sch
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.kv_cache import CachePool
    from repro_torch.testing import (LLM_RTOL, ROUTER_TIE, RouterTap,
                                     router_margin)
    params = {"cuda": tfm.init_params(cfg, SEED, "cuda")}
    params["cpu"] = sch.tree_map(lambda t: t.cpu(), params["cuda"])
    ctxs = {"cuda": ctx, "cpu": None if ctx is None else ctx.cpu()}
    reqs = llm_requests(np, cfg, 4, 40, 1, seed=1)
    pools = {d: CachePool(cfg, 4, 64, d) for d in ("cuda", "cpu")}
    worst, ties, compared, exempt, margins = 0.0, 0, 0, 0, []

    def run(d, fn):
        with RouterTap() as tap:
            out = fn(d)
        return out, tap.calls

    def check(what, out, calls):
        """Compare one call's logits; True when rows were exempt."""
        nonlocal worst, ties, compared, exempt
        got, want = out["cuda"].cpu().numpy(), out["cpu"].numpy()
        if not np.isfinite(got).all():
            raise AssertionError(f"{what}: non-finite logits on the card")
        scale = max(1.0, float(np.abs(want).max()))
        row_err = np.abs(got - want).max(-1) / scale
        top2 = np.sort(want, -1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) < LLM_RTOL * scale
        bad = (row_err > LLM_RTOL) | ((got.argmax(-1) != want.argmax(-1))
                                      & ~near)
        if bad.any():
            margin = min(router_margin(c) for c in calls.values())
            print(f"{what}: rows {np.nonzero(bad)[0].tolist()} differ by "
                  f"{row_err.max():.2e} of the logit scale; smallest "
                  f"k/(k+1) routing margin of the call {margin:.3e} "
                  f"[{card}]")
            if not margin < ROUTER_TIE:
                raise AssertionError(f"{what}: card vs CPU logits differ "
                                     "away from a top-2 tie and from a "
                                     "router tie")
            exempt += int(bad.sum())
            margins.append(margin)
        worst = max([worst] + row_err[~bad].tolist())
        ties += int(near[~bad].sum())
        compared += int((~bad).sum())
        return bool(bad.any())

    def resync():
        pools["cpu"].cache = sch.tree_map(lambda t: t.cpu(),
                                          pools["cuda"].cache)

    nxt = np.zeros((4, 1), np.int64)
    for slot, req in enumerate(reqs):
        out, calls, ones = {}, {}, {}
        for d in ("cuda", "cpu"):
            toks = torch.as_tensor(req.prompt, device=d)[None]
            row = None if ctx is None else ctxs[d][slot:slot + 1]
            (out[d], ones[d]), calls[d] = run(d, lambda d: tfm.prefill(
                cfg, params[d], toks, tfm.init_cache(cfg, 1, 64, d),
                ctx_embed=row))
            pools[d].write_prefill(slot, ones[d], len(req.prompt))
        if check(f"prefill {slot}", out, calls):
            resync()
        nxt[slot, 0] = int(out["cuda"][0].argmax())
    lens = np.asarray([len(r.prompt) for r in reqs])
    for step in range(6):
        out, calls = {}, {}
        for d in ("cuda", "cpu"):
            (out[d], pools[d].cache), calls[d] = run(
                d, lambda d: tfm.decode_step(
                    cfg, params[d], torch.as_tensor(nxt, device=d),
                    pools[d].cache, torch.as_tensor(lens + step, device=d),
                    ctx_embed=ctxs[d]))
            out[d] = out[d][:, 0]
        if check(f"decode step {step}", out, calls):
            resync()
        nxt[:, 0] = out["cuda"].argmax(-1).cpu().numpy()
    print(f"LLM card vs CPU reference, {cfg.name} at full width "
          f"({sch.param_bytes(tfm.model_schema(cfg)) / 4e9:.3f} B "
          f"parameters): 4 prefills + 6 decode steps, logits within "
          f"{worst:.2e} of their scale (tolerance {LLM_RTOL}), greedy tokens "
          f"equal at {compared - ties} of {compared} positions ({ties} "
          f"top-2 tie(s) exempt); {exempt} row(s) exempt at router ties "
          f"(margins {margins}, tie below {ROUTER_TIE}) [{card}]")
    del params, pools
    torch.cuda.empty_cache()
    return {"worst": worst, "ties": ties, "compared": compared,
            "router_exempt": exempt}


def block_cut(cfg, num_blocks: int):
    """``cfg`` cut to its prefix, ``num_blocks`` blocks and its suffix: the
    same widths and vocabulary."""
    import dataclasses
    layers = len(cfg.prefix_layers) + num_blocks * len(cfg.block_pattern) \
        + len(cfg.suffix_layers)
    return dataclasses.replace(cfg, name=f"{cfg.name}-{layers}-layers",
                               num_layers=layers, num_blocks=num_blocks)


def phase_llm_reference(torch, np, card):
    """zamba2-7b at full width cut to 9 layers (the prefix and one block)."""
    from repro_torch.configs import get_config
    return llm_reference(torch, np, card,
                         block_cut(get_config(LLM_ARCH), 1))


def phase_gemma2_reference(torch, np, card):
    """gemma2-9b at full width cut to two blocks (two LOCAL and two global
    layers), float32, card against CPU."""
    from repro_torch.configs import get_config
    return llm_reference(torch, np, card,
                         block_cut(get_config(GEMMA_ARCH), 2))


def phase_gemma2_serve(torch, card) -> dict:
    """gemma2-9b's float32 serving path alone (``--only gemma2_serve``; with
    --parent on each tree's package, each in a process of its own): its
    two-block cut against the CPU, then the full width behind LLMServer,
    summed up in one line: prefill ms a request, decode ms a step,
    tokens/s, the device's busy share of a traced prefill and decode step,
    the K6 and K7 launches."""
    import numpy as np
    check = phase_gemma2_reference(torch, np, card)
    counts, _, params, got = phase_llm_main_path(torch, np, card, GEMMA_ARCH)
    del params
    torch.cuda.empty_cache()
    busy = {what: b / w for what, (w, b) in got["profile"].items()}
    print(f"gemma2 serve float32: prefill {got['prefill_ms']:.2f} ms a "
          f"request, decode {got['decode_ms']:.2f} ms a step, "
          f"{got['tokens_per_s']:.2f} tokens/s; device busy "
          f"{busy['prefill']:.1%} of a traced prefill, "
          f"{busy['decode step']:.1%} of a decode step; launches K6 "
          f"{counts['flash_attention']}, K7 {counts['decode_attention']}; "
          f"the cut against the CPU within {check['worst']:.2e}, greedy "
          f"tokens equal at {check['compared'] - check['ties']} of "
          f"{check['compared']} [{card}]")
    return got


def phase_moe_reference(torch, np, card):
    """deepseek-v2-lite at full width cut to its dense prefix and two MoE
    blocks (~1.6 B parameters, 6.5 GB on the host)."""
    from repro_torch.configs import get_config
    return llm_reference(torch, np, card, block_cut(get_config(MOE_ARCH), 2))


def cross_context(torch, cfg, n: int):
    """Stub frontend embeddings (n, num_ctx_tokens, ctx_dim) on the card,
    from SEED."""
    from repro_torch.models import stubs
    return stubs.frontend_embeddings(
        cfg, n, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")


def phase_cross_reference(torch, np, card):
    """musicgen-medium at full width cut to 4 layers, with stub context."""
    from repro_torch.configs import get_config
    cfg = block_cut(get_config(CROSS_ARCH), 4)
    return llm_reference(torch, np, card, cfg, cross_context(torch, cfg, 4))


def phase_cross_main_path(torch, np, card):
    """musicgen-medium at full width over stub conditioning embeddings
    (LLM_SLOTS x 256 x 768): one prefill of LLM_SLOTS prompts of LLM_PROMPT
    tokens into an LLM_SLOTS-slot pool, then LLM_NEW per-slot greedy decode
    steps, through ``transformer.prefill`` / ``decode_step`` (``LLMServer``
    takes no context, as in the reference).  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.kv_cache import CachePool
    cfg = get_config(CROSS_ARCH)
    params = draw_full_width(torch, card, cfg)
    ctx = cross_context(torch, cfg, LLM_SLOTS)
    toks = torch.as_tensor(cascade_tokens(np, cfg, LLM_SLOTS, LLM_PROMPT,
                                          SEED), device="cuda")

    def run():
        pool = CachePool(cfg, LLM_SLOTS, LLM_MAX_SEQ, "cuda")
        times = {"prefill": [], "decode": []}
        t0 = time.perf_counter()
        logits, pool.cache = tfm.prefill(cfg, params, toks, pool.cache,
                                         ctx_embed=ctx)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t0)
        out, confs = [logits.argmax(-1)], [torch.softmax(logits, -1).amax(-1)]
        for step in range(LLM_NEW):
            t1 = time.perf_counter()
            idx = torch.full((LLM_SLOTS,), LLM_PROMPT + step, device="cuda")
            logits, pool.cache = tfm.decode_step(cfg, params, out[-1][:, None],
                                                 pool.cache, idx,
                                                 ctx_embed=ctx)
            out.append(logits[:, 0].argmax(-1))
            confs.append(torch.softmax(logits[:, 0], -1).amax(-1))
            torch.cuda.synchronize()
            times["decode"].append(time.perf_counter() - t1)
        return (torch.stack(out, 1).cpu().numpy(),
                torch.stack(confs, 1).cpu().numpy(), times,
                time.perf_counter() - t0)

    run()                                         # warm-up (allocator)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tokens, confs, times, wall = run()
    counts = ops.launch_counts()
    steps = LLM_NEW
    if not (tokens.shape == (LLM_SLOTS, LLM_NEW + 1)
            and ((0 <= tokens) & (tokens < cfg.padded_vocab)).all()
            and ((0 < confs) & (confs <= 1)).all()):
        raise AssertionError(f"{CROSS_ARCH}: tokens {tokens}, confidences "
                             f"{confs}")
    want = path_launches(cfg, 1, steps)
    check_launches(counts, want, f"{CROSS_ARCH}'s cross-attention path")
    print(f"cross-attention main path: {CROSS_ARCH} full width, stub "
          f"context {tuple(ctx.shape)}, {LLM_SLOTS} prompts x {LLM_PROMPT} "
          f"tokens in one prefill, then {steps} per-slot decode steps: "
          f"{wall:.3f} s wall, {tokens.size} tokens, "
          f"{tokens.size / wall:.2f} tokens/s; prefill "
          f"{times['prefill'][0] * 1e3:.2f} ms for the {LLM_SLOTS} prompts, "
          f"decode {statistics.median(times['decode']) * 1e3:.2f} ms per "
          f"step (median of {steps}, min "
          f"{min(times['decode']) * 1e3:.2f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{ {k: counts[k] for k in want} } [{card}]")
    profile_llm(torch, np, card, cfg, params, ctx)
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the big/little LLM cascade (core/cascade.py) on zamba2-7b
# ---------------------------------------------------------------------------
CASCADE_REQUESTS, CASCADE_TOKENS = 8, 64


def cascade_tokens(np, cfg, n, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, s))


def phase_cascade(torch, np, card, cfg, params):
    """``BigLittleCascade`` with full-width zamba2-7b as the big model and
    its 9-layer cut (the same weights' prefix and first block) as the
    little one, CASCADE_REQUESTS x CASCADE_TOKENS-token requests at three
    thresholds: 1.1 (all escalate), 0.0 (none) and the median of the
    little model's confidences (about half).  Returns the launch counts of
    the three answers."""
    from repro_torch.core.cascade import BigLittleCascade, CascadeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import schema as sch
    little_cfg = block_cut(cfg, 1)
    little = dict(params, blocks=sch.tree_map(lambda t: t[:1],
                                              params["blocks"]))
    toks = cascade_tokens(np, cfg, CASCADE_REQUESTS, CASCADE_TOKENS, SEED)

    def cascade(thr):
        return BigLittleCascade(little_cfg, little, cfg, params,
                                CascadeConfig(escalate_below=thr),
                                device="cuda")

    _, info = cascade(1.1).answer(toks)           # warm-up; both models
    thresholds = (1.1, 0.0, float(np.median(info["confidence"])))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lines, rates, want = [], [], {"flash_attention": 0, "ssd_scan": 0}
    for thr in thresholds:
        c = cascade(thr)
        t0 = time.perf_counter()
        pred, info = c.answer(toks)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        st = c.stats
        if not (pred.shape == (CASCADE_REQUESTS,)
                and ((0 <= pred) & (pred < cfg.vocab_size)).all()
                and np.isfinite(info["confidence"]).all()
                and np.isfinite(c.logit_bias.cpu().numpy()).all()):
            raise AssertionError(f"cascade at {thr}: {pred} {info}")
        if st.adapter_updates != st.escalated:
            raise AssertionError(f"cascade at {thr}: {st}")
        for cut, run in ((little_cfg, True), (cfg, st.escalated > 0)):
            k6, k8 = llm_kernel_calls(cut)
            want["flash_attention"] += k6 * run
            want["ssd_scan"] += k8 * run
        rates.append(st.escalation_rate)
        lines.append(f"threshold {thr:.6g}: escalation rate "
                     f"{st.escalation_rate:.3f}, {st.adapter_updates} "
                     f"adapter updates, agreement "
                     f"{st.agreement[0] if st.agreement else None}, "
                     f"{ms:.2f} ms per answer")
    counts = ops.launch_counts()
    check_launches(counts, want, "cascade")
    if not (rates[0] == 1.0 and rates[1] == 0.0 and 0 < rates[2] < 1):
        raise AssertionError(f"cascade escalation rates {rates}")
    print(f"cascade: big {cfg.name} full width, little its 9-layer cut, "
          f"{CASCADE_REQUESTS} requests x {CASCADE_TOKENS} tokens; "
          + "; ".join(lines) + f"; K6 {counts['flash_attention']} and K8 "
          f"{counts['ssd_scan']} launches [{card}]")
    return counts


def cascade_tie_rows(np, casc, toks, rows, escalated):
    """Rows (of ``rows``) whose deciding logits, the little model's with
    the bias or the big model's where the row escalated, have a top-2 gap
    within LLM_RTOL of their scale on ``casc``'s device."""
    import torch

    from repro_torch.testing import LLM_RTOL
    out = []
    with torch.inference_mode():
        t = torch.as_tensor(toks[rows], device=casc.device)
        lil = (casc._last_logits(casc.little_cfg, casc.little_params, t)
               [:, -1] + casc.logit_bias).cpu().numpy()
        big = casc._last_logits(casc.big_cfg, casc.big_params,
                                t)[:, -1].cpu().numpy()
    for j, r in enumerate(rows):
        x = big[j] if escalated[r] else lil[j]
        top2 = np.sort(x)[-2:]
        if top2[1] - top2[0] < LLM_RTOL * max(1.0, float(np.abs(x).max())):
            out.append(r)
    return out


def compare_cascades(np, card, cpu, toks, what):
    """One ``answer`` on the card and on the CPU: confidences within
    LLM_RTOL, the escalation mask equal except within THRESHOLD_TIE of the
    threshold, predictions equal except at top-2 ties, and the learned
    logit bias within LLM_RTOL of its scale.  Returns the exempt rows."""
    from repro_torch.testing import LLM_RTOL, THRESHOLD_TIE, rel_err
    pa, ia = card.answer(toks)
    pb, ib = cpu.answer(toks)
    np.testing.assert_allclose(ia["confidence"], ib["confidence"],
                               rtol=LLM_RTOL, err_msg=what)
    near = np.abs(ib["confidence"] - cpu.ccfg.escalate_below) <= \
        THRESHOLD_TIE
    if ((ia["escalated"] != ib["escalated"]) & ~near).any():
        raise AssertionError(f"{what}: escalation differs away from the "
                             "threshold")
    differ = [int(r) for r in np.nonzero((pa != pb) & ~near)[0]]
    ties = cascade_tie_rows(np, cpu, toks, differ, ib["escalated"]) \
        if differ else []
    if set(differ) - set(ties):
        raise AssertionError(f"{what}: predictions differ away from ties at "
                             f"rows {sorted(set(differ) - set(ties))}")
    err = rel_err(card.logit_bias.cpu().numpy(), cpu.logit_bias.numpy())
    if err > LLM_RTOL:
        raise AssertionError(f"{what}: logit bias {err:.2e} apart")
    return int(near.sum()) + len(ties), err


def phase_cascade_reference(torch, np, card):
    """The cascade on the card against the port's CPU path: both models
    zamba2-7b's 9-layer cut at full width (the little from SEED, the big
    from SEED + 1), CASCADE_REQUESTS x CASCADE_TOKENS tokens, the shapes
    phase_cascade runs: one answer where all escalate (on phase_cascade's
    tokens), then one with the learned bias at the median of the little
    model's confidences (on a second draw)."""
    from repro_torch.configs import get_config
    from repro_torch.core.cascade import BigLittleCascade, CascadeConfig
    from repro_torch.models import schema as sch
    from repro_torch.models import transformer as tfm
    cfg = block_cut(get_config(LLM_ARCH), 1)
    params = {"cuda": [tfm.init_params(cfg, s, "cuda")
                       for s in (SEED, SEED + 1)]}
    params["cpu"] = [sch.tree_map(lambda t: t.cpu(), p)
                     for p in params["cuda"]]
    casc = {d: BigLittleCascade(cfg, params[d][0], cfg, params[d][1],
                                CascadeConfig(escalate_below=1.1), device=d)
            for d in ("cuda", "cpu")}
    toks = [cascade_tokens(np, cfg, CASCADE_REQUESTS, CASCADE_TOKENS,
                           SEED + s) for s in (0, 1)]
    exempt, err1 = compare_cascades(np, casc["cuda"], casc["cpu"], toks[0],
                                    "cascade card vs CPU, all escalate")
    # the learned bias's confidences on the second batch, from a cascade
    # that escalates nothing (so updates nothing)
    probe = BigLittleCascade(cfg, params["cuda"][0], cfg, params["cuda"][1],
                             CascadeConfig(escalate_below=0.0),
                             device="cuda")
    probe.logit_bias = casc["cuda"].logit_bias
    thr = float(np.median(probe.answer(toks[1])[1]["confidence"]))
    for c in casc.values():
        c.ccfg = CascadeConfig(escalate_below=thr)
    n, err2 = compare_cascades(np, casc["cuda"], casc["cpu"], toks[1],
                               "cascade card vs CPU, learned bias")
    sa, sb = casc["cuda"].stats, casc["cpu"].stats
    if not exempt + n and (sa.escalated, sa.adapter_updates,
                           sa.agreement) != (sb.escalated,
                                             sb.adapter_updates,
                                             sb.agreement):
        raise AssertionError(f"cascade stats card {sa} vs CPU {sb}")
    print(f"cascade card vs CPU reference, {cfg.name} little and big "
          f"(seeds {SEED}, {SEED + 1}), {CASCADE_REQUESTS} requests x "
          f"{CASCADE_TOKENS} tokens: all-escalate answer then the "
          f"learned bias at threshold {thr:.6g}; confidences within "
          f"LLM_RTOL, escalation masks equal, predictions equal "
          f"({exempt + n} tie row(s) exempt), logit bias {err1:.2e} and "
          f"{err2:.2e} of its scale apart; escalated {sb.escalated} of "
          f"{2 * CASCADE_REQUESTS} [{card}]")
    del params, casc, probe
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# LLM training (M11.3): K6 and K8 forward on the card, their plain
# versions' VJPs backward (kernels.ops); the step against the CPU on a
# 9-layer cut, then train_llm on zamba2-7b at full width cut to 17 layers
# ---------------------------------------------------------------------------
TRAIN_LLM_BLOCKS, TRAIN_LLM_BATCH, TRAIN_LLM_SEQ = 2, 4, 512
TRAIN_LLM_STEPS, TRAIN_LLM_REMAT_STEPS, TRAIN_LLM_LR = 6, 2, 3e-4
TRAIN_REF_SEQ = 256
# the K6 and K8 shapes of the training path: zamba2's shared attention and
# Mamba2 layers at TRAIN_LLM_BATCH x TRAIN_LLM_SEQ
ATTN_TRAIN_SHAPE = (4, 512, 512, 32, 32, 112, 112, True, None, None, 0)
SSD_TRAIN_SHAPE = (4, 512, 112, 64, 64, 256, False, True)


def grad_cases():
    """(K6 cases, K8 cases) of the gradient phase: every CPU test case,
    musicgen's cross-attention prefill, then the training path's shapes
    (the last of each)."""
    from repro_torch.testing import (FLASH_CASES, FLASH_DV_CASES,
                                     FLASH_RAGGED_CASES, SSD_CASES)
    attn = ([c[:6] + (c[5],) + c[6:] for c in FLASH_CASES
             + FLASH_RAGGED_CASES] + FLASH_DV_CASES
            + [(4, 384, 256, 24, 24, 64, 64, False, None, None, 0),
               ATTN_TRAIN_SHAPE])
    return attn, list(SSD_CASES) + [SSD_TRAIN_SHAPE]


def _grads_against_plain(torch, call, plain, leaves, seed):
    """(outputs, gradients) of ``call`` (through ``ops``: the Function) and
    of ``plain`` on the same CUDA leaves, against one seeded cotangent per
    output: {"kernel": ..., "plain": ...}."""
    out = {}
    for what, fn in (("kernel", call), ("plain", plain)):
        res = fn()
        res = res if isinstance(res, tuple) else (res,)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        cots = [torch.randn(r.shape, generator=gen, device="cuda")
                for r in res]
        out[what] = ([r.detach() for r in res],
                     torch.autograd.grad(res, leaves, cots))
    return out


def phase_llm_grad(torch, np, card):
    """K6 and K8 under autograd on the card, at every grad_cases() shape:
    the Function's forward (the kernel) within ATTN_ATOL / SSD_RTOL of the
    plain version and its gradients (the plain version's VJP, recomputed)
    within ATTN_VJP_RTOL / SSD_VJP_RTOL of ``torch.autograd.grad`` of the
    plain version on the same tensors; each shape's forward kernel and
    plain VJP timed per call.  Returns {"flash_attention": [...],
    "ssd_scan": [...]}, one record a shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.testing import (ATTN_ATOL, ATTN_VJP_RTOL, SSD_RTOL,
                                     SSD_VJP_RTOL, attention_case, rel_err,
                                     ssd_case)
    attn_cases, ssd_cases = grad_cases()
    out = {"flash_attention": [], "ssd_scan": []}

    def record(name, shape, fwd_err, grad_err, kernel, vjp, tol):
        with torch.no_grad():
            fwd_ms = time_ms(torch, kernel, reps=10, warmup=2)
        vjp_ms = time_ms(torch, vjp, reps=10, warmup=2)
        rec = dict(shape=shape, forward_err=fwd_err, grad_err=grad_err,
                   forward_ms=fwd_ms, vjp_ms=vjp_ms)
        out[name].append(rec)
        print(f"{name} gradient {shape}: forward error {fwd_err:.3e}, "
              f"gradients {grad_err:.3e} of their scale (tolerance {tol}); "
              f"forward kernel {fwd_ms:.4f} ms per call, plain VJP "
              f"{vjp_ms:.4f} ms per call [{card}]")

    for b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off in \
            attn_cases:
        q, k, v = (torch.as_tensor(a, device="cuda").requires_grad_(True)
                   for a in attention_case(b, s_q, s_kv, n_q, n_kv, d,
                                           seed=SEED, d_v=d_v))
        kw = dict(causal=causal, window=window, softcap=cap,
                  q_offset=torch.as_tensor(off, device="cuda"))
        ops.reset_launch_counts()
        res = _grads_against_plain(
            torch, lambda: ops.flash_attention(q, k, v, **kw),
            lambda: fa.flash_attention_ref(q, k, v, **kw), (q, k, v), SEED)
        counts = ops.launch_counts()
        if (counts["flash_attention"], counts["flash_attention_vjp"]) != \
                (1, 1):
            raise AssertionError(f"K6 under autograd: {counts}")
        (got, g_got), (want, g_want) = res["kernel"], res["plain"]
        fwd_err = float((got[0] - want[0]).abs().max())
        grad_err = max(rel_err(a.cpu().numpy(), w.cpu().numpy())
                       for a, w in zip(g_got, g_want))
        shape = (f"b={b} s_q={s_q} s_kv={s_kv} heads={n_q}/{n_kv} d={d} "
                 f"d_v={d_v} causal={causal} window={window} softcap={cap} "
                 f"q_offset={off}")
        if not (fwd_err <= ATTN_ATOL and grad_err <= ATTN_VJP_RTOL and all(
                bool(torch.isfinite(g).all()) for g in g_got)):
            raise AssertionError(f"K6 gradient at {shape}: forward "
                                 f"{fwd_err}, gradients {grad_err}")
        cot = torch.randn(got[0].shape, device="cuda")
        record("flash_attention", shape, fwd_err, grad_err,
               lambda: ops.flash_attention(q, k, v, **kw),
               lambda: fa.flash_attention_vjp(q, k, v, cot, **kw),
               ATTN_VJP_RTOL)
    for b, s, h, p, n, chunk, init, weak in ssd_cases:
        x, dt, A, B, C, st = (None if a is None else
                              torch.as_tensor(a, device="cuda")
                              .requires_grad_(True) for a in
                              ssd_case(b, s, h, p, n, init, seed=SEED,
                                       weak=weak))
        leaves = [t for t in (x, dt, A, B, C, st) if t is not None]
        kw = dict(chunk=chunk, initial_state=st)
        ops.reset_launch_counts()
        res = _grads_against_plain(
            torch, lambda: ops.ssd_scan(x, dt, A, B, C, **kw),
            lambda: sk.ssd_scan_ref(x, dt, A, B, C, **kw), leaves, SEED)
        counts = ops.launch_counts()
        if (counts["ssd_scan"], counts["ssd_scan_vjp"]) != (1, 1):
            raise AssertionError(f"K8 under autograd: {counts}")
        (got, g_got), (want, g_want) = res["kernel"], res["plain"]
        fwd_err = max(rel_err(a.cpu().numpy(), w.cpu().numpy())
                      for a, w in zip(got, want))
        grad_err = max(rel_err(a.cpu().numpy(), w.cpu().numpy())
                       for a, w in zip(g_got, g_want))
        shape = (f"b={b} s={s} h={h} p={p} n={n} chunk={chunk} "
                 f"initial_state={init} weak_decay={weak}")
        if not (fwd_err <= SSD_RTOL and grad_err <= SSD_VJP_RTOL and all(
                bool(torch.isfinite(g).all()) for g in g_got)):
            raise AssertionError(f"K8 gradient at {shape}: forward "
                                 f"{fwd_err}, gradients {grad_err}")
        cy, cf = (torch.randn(t.shape, device="cuda") for t in got)
        record("ssd_scan", shape, fwd_err, grad_err,
               lambda: ops.ssd_scan(x, dt, A, B, C, **kw),
               lambda: sk.ssd_scan_vjp(x, dt, A, B, C, cy, cf, **kw),
               SSD_VJP_RTOL)
    return out


class CaptureGrads:
    """An optimizer that keeps the gradients of each ``update`` and hands
    the rest to the optimizer it wraps."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads.append(grads)
        return self.opt.update(grads, state, params)


def phase_llm_train_reference(torch, np, card):
    """One ``make_train_step`` step (AdamW at TRAIN_LLM_LR, no remat) of
    zamba2-7b at full width cut to 9 layers, batch 1 x TRAIN_REF_SEQ tokens
    from ``TokenStream``, on the card and on the CPU from the same numpy
    weights (``weights.llm_from_numpy_tree``): the loss within 1e-5
    relative, every gradient leaf and the parameters after the step
    (``assert_train_params_close``) within LLM_GRAD_CARD_RTOL of their
    scale.  Beside it, as a yardstick, the gradients of the plain program
    on the card (K6 and K8 replaced by their plain versions, no kernel at
    all) against the CPU's: the float32 program's own spread between the
    two devices."""
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.models import schema as sch
    from repro_torch.models import transformer as tfm
    from repro_torch.testing import (LLM_GRAD_CARD_RTOL,
                                     assert_train_params_close, leaf_rel_err)
    from repro_torch.training import data, train_loop
    from repro_torch.training.optimizer import AdamW
    cfg = block_cut(get_config(LLM_ARCH), 1)
    tree = sch.tree_map(lambda t: t.numpy(), tfm.init_params(cfg, SEED,
                                                             "cpu"))
    batch = next(iter(data.TokenStream(cfg.vocab_size, TRAIN_REF_SEQ, 1,
                                       SEED)))
    runs, wall = {}, {}
    for dev in ("cuda", "cpu"):
        params = weights.llm_from_numpy_tree(tree, dev)
        opt = CaptureGrads(AdamW(lr=TRAIN_LLM_LR))
        step = train_loop.make_train_step(cfg, opt, remat=False)
        t0 = time.perf_counter()
        new, state, m = step(params, opt.init(params),
                             train_loop.to_device(batch, dev))
        loss = float(m["loss"])
        wall[dev] = time.perf_counter() - t0
        runs[dev] = (weights._flatten(new, hwio=False),
                     weights._flatten(opt.grads[0], hwio=False), loss)
        del params, new, state, opt, step
    (p, g, loss), (p0, g0, loss0) = runs["cuda"], runs["cpu"]
    # the yardstick: the plain program's gradients on the card
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention, ops.ssd_scan
    ops.flash_attention, ops.ssd_scan = ref.flash_attention, ref.ssd_scan
    try:
        plain = weights._flatten(train_loop.llm_grads(
            cfg, weights.llm_from_numpy_tree(tree, "cuda"),
            train_loop.to_device(batch, "cuda"), remat=False)[1],
            hwio=False)
    finally:
        ops.flash_attention, ops.ssd_scan = saved
    del tree
    torch.cuda.empty_cache()
    plain_err = max(leaf_rel_err(plain[k], g0[k]) for k in g0)
    del plain
    card_s, cpu_s = wall["cuda"], wall["cpu"]
    loss_err = abs(loss - loss0) / abs(loss0)
    errs = {k: leaf_rel_err(g[k], g0[k]) for k in g0}
    worst = max(errs, key=errs.get)
    if not (np.isfinite(loss) and loss_err <= 1e-5 and g.keys() == g0.keys()
            and errs[worst] <= LLM_GRAD_CARD_RTOL):
        raise AssertionError(f"LLM train step card vs CPU: loss {loss} vs "
                             f"{loss0}, worst gradient {worst} "
                             f"{errs[worst]:.3e}")
    p_err = assert_train_params_close(p, p0, g0, TRAIN_LLM_LR, 1,
                                      "LLM train step card vs CPU",
                                      rtol=LLM_GRAD_CARD_RTOL)
    print(f"LLM train step card vs CPU reference, {cfg.name} at full width "
          f"({cfg.param_count() / 1e9:.3f} B parameters), 1 x "
          f"{TRAIN_REF_SEQ} tokens, AdamW lr {TRAIN_LLM_LR}: loss {loss:.6f}"
          f" ({loss_err:.2e} relative), gradients within {errs[worst]:.2e} "
          f"of their leaf's scale (worst {worst}; LLM_GRAD_CARD_RTOL "
          f"{LLM_GRAD_CARD_RTOL}; the plain program on the card, no "
          f"kernel, {plain_err:.2e}), parameters within {p_err:.2e}; one "
          f"step {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU "
          f"[{card}]")
    return {"loss_err": loss_err, "grad_err": errs[worst],
            "worst_leaf": worst, "params_err": p_err,
            "plain_on_card_grad_err": plain_err}


class LLMStepSplit:
    """CUDA events around each ``transformer.loss_fn`` (the forward), each
    ``train_loop.llm_grads`` (forward and backward), each
    ``AdamW.update`` (the optimizer) and each plain VJP of K6 and K8, and
    the host clock around each batch ``TokenStream`` draws and each
    ``train_loop.to_device``; every one is looked up at call time, so
    wrapping the attributes reaches the training loop's calls."""

    def __init__(self, torch):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ssd_scan as sk
        from repro_torch.models import transformer as tfm
        from repro_torch.training import data, train_loop
        from repro_torch.training.optimizer import AdamW
        self.torch = torch
        self.events = {"forward": [], "grads": [], "optimizer": [],
                       "vjp": []}
        self.host_s = {"batch": [], "copy": []}
        self.targets = [(tfm, "loss_fn", "forward"),
                        (train_loop, "llm_grads", "grads"),
                        (AdamW, "update", "optimizer"),
                        (fa, "flash_attention_vjp", "vjp"),
                        (sk, "ssd_scan_vjp", "vjp"),
                        (train_loop, "to_device", "copy"),
                        (data.TokenStream, "__iter__", "batch")]

    def __enter__(self):
        self.saved = [(o, n, getattr(o, n)) for o, n, _ in self.targets]
        for (obj, name, fn), (_, _, part) in zip(self.saved, self.targets):
            wrap = (self._batches if part == "batch" else self._host
                    if part == "copy" else self._device)
            setattr(obj, name, wrap(fn, part))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)
        return False

    def _device(self, fn, part):
        torch = self.torch

        def call(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events[part].append((start, end))
            return out
        return call

    def _host(self, fn, part):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.host_s[part].append(time.perf_counter() - t0)
            return out
        return call

    def _batches(self, fn, part):
        split = self

        def batches(stream):
            it = fn(stream)
            while True:
                t0 = time.perf_counter()
                batch = next(it)
                split.host_s[part].append(time.perf_counter() - t0)
                yield batch
        return batches

    def ms(self, steps: int) -> dict:
        """Milliseconds per step of each part; backward = grads - forward."""
        self.torch.cuda.synchronize()
        out = {part: sum(s.elapsed_time(e) for s, e in ev) / steps
               for part, ev in self.events.items()}
        out.update({part: sum(v) * 1e3 / steps
                    for part, v in self.host_s.items()})
        out["backward"] = out["grads"] - out["forward"]
        return out


def train_launches(cfg, remat: bool) -> dict:
    """K6, K8 and VJP counts of one training step of ``cfg``: a forward,
    with remat the block units' forward again, and one VJP a forward
    launch of the first pass."""
    kinds = layer_kinds(cfg)
    unit = list(cfg.block_pattern) * cfg.num_blocks
    k6 = sum(k in ATTN_KINDS for k in kinds) + kinds.count("cross")
    k8 = sum(k in ("ssm", "ssm_ffn") for k in kinds)
    r6 = sum(k in ATTN_KINDS for k in unit) + unit.count("cross")
    r8 = sum(k in ("ssm", "ssm_ffn") for k in unit)
    return {"flash_attention": k6 + remat * r6,
            "ssd_scan": k8 + remat * r8,
            "flash_attention_vjp": k6, "ssd_scan_vjp": k8}


def phase_llm_train_main_path(torch, np, card):
    """``train_loop.train_llm`` on zamba2-7b at full width cut to
    TRAIN_LLM_BLOCKS blocks (17 layers), TRAIN_LLM_BATCH x TRAIN_LLM_SEQ
    tokens, TRAIN_LLM_STEPS steps without remat; then TRAIN_LLM_REMAT_STEPS
    ``make_train_step`` steps with remat from the same init and batches.
    Counts zeroed before and read after each run; the loss must fall and
    the remat run's losses equal the first run's within LLM_RTOL.  Prints
    the step split, tokens/s, peak memory and, from one profiled step, the
    device-busy share and the plain VJPs' device time.  Returns the counts
    of both runs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.models import transformer as tfm
    from repro_torch.testing import LLM_RTOL
    from repro_torch.training import data, train_loop
    from repro_torch.training.optimizer import AdamW
    cfg = block_cut(get_config(LLM_ARCH), TRAIN_LLM_BLOCKS)
    tokens = TRAIN_LLM_BATCH * TRAIN_LLM_SEQ
    kw = dict(batch_size=TRAIN_LLM_BATCH, seq_len=TRAIN_LLM_SEQ,
              lr=TRAIN_LLM_LR, seed=SEED, device="cuda")
    print(f"LLM training: {cfg.name} at full width, "
          f"{cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.param_count() * 16 / 1e9:.1f} GB of float32 weights, "
          f"gradients and AdamW moments [{card}]")
    # warm-up: the allocator and cuBLAS at these shapes
    train_loop.train_llm(cfg, steps=1, **kw)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    with LLMStepSplit(torch) as split:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, hist = train_loop.train_llm(cfg, steps=TRAIN_LLM_STEPS,
                                            log_every=1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[False] = ops.launch_counts()
        parts = split.ms(TRAIN_LLM_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    if not (len(losses) == TRAIN_LLM_STEPS and np.isfinite(losses).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"LLM training: the loss did not fall: {hist}")

    # one profiled step from the trained weights (its own optimizer state)
    opt = AdamW(lr=TRAIN_LLM_LR)
    step = train_loop.make_train_step(cfg, opt, remat=False)
    batch = train_loop.to_device(next(iter(data.TokenStream(
        cfg.vocab_size, TRAIN_LLM_SEQ, TRAIN_LLM_BATCH, SEED))), "cuda")
    state = opt.init(params)
    saved = fa.flash_attention_vjp, sk.ssd_scan_vjp

    def labelled(fn, name):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call
    fa.flash_attention_vjp = labelled(saved[0], "plain VJP K6")
    sk.ssd_scan_vjp = labelled(saved[1], "plain VJP K8")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step(params, state, batch)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t1
    finally:
        fa.flash_attention_vjp, sk.ssd_scan_vjp = saved
    del params, state, batch
    torch.cuda.empty_cache()
    # the VJPs' labels are spans on the device timeline, not kernels: they
    # give the VJPs' device time and stay out of the busy sum
    avgs = [e for e in prof.key_averages()
            if not e.key.startswith("plain VJP")]
    busy = sum(_self_device_us(e) for e in avgs) / 1e3
    vjp_prof = {e.key: (getattr(e, "device_time_total", 0.0)
                        or getattr(e, "cuda_time_total", 0.0)) / 1e3
                for e in prof.key_averages()
                if e.key.startswith("plain VJP")}
    top = sorted(avgs, key=_self_device_us, reverse=True)[:6]

    # remat: the same init and batches, TRAIN_LLM_REMAT_STEPS steps
    params = tfm.init_params(cfg, SEED, "cuda")
    opt = AdamW(lr=TRAIN_LLM_LR)
    step = train_loop.make_train_step(cfg, opt, remat=True)
    state, remat_losses = opt.init(params), []
    stream = iter(data.TokenStream(cfg.vocab_size, TRAIN_LLM_SEQ,
                                   TRAIN_LLM_BATCH, SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t2 = time.perf_counter()
    for _ in range(TRAIN_LLM_REMAT_STEPS):
        params, state, m = step(params, state, train_loop.to_device(
            next(stream), "cuda"))
        remat_losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    rwall = time.perf_counter() - t2
    runs[True] = ops.launch_counts()
    rpeak = torch.cuda.max_memory_allocated()
    del params, state
    torch.cuda.empty_cache()
    apart = max(abs(a - b) / abs(b) for a, b in zip(remat_losses, losses))
    if apart > LLM_RTOL:
        raise AssertionError(f"remat losses {remat_losses} vs {losses}")
    for remat, steps in ((False, TRAIN_LLM_STEPS),
                         (True, TRAIN_LLM_REMAT_STEPS)):
        want = {k: n * steps for k, n in train_launches(cfg, remat).items()}
        want.update({k: 0 for k in ops.KERNELS
                     if k not in ("flash_attention", "ssd_scan")})
        check_launches(runs[remat], want, f"LLM training (remat={remat})")
    step_ms = wall * 1e3 / TRAIN_LLM_STEPS
    vjp_ms = sum(vjp_prof.values())
    vjp_txt = (", ".join(f"{k} {v:.2f} ms" for k, v in vjp_prof.items())
               + f": {vjp_ms / parts['backward']:.1%} of the timed backward"
               if vjp_ms else "not measured")
    print(f"LLM training main path: {cfg.name} full width, "
          f"{TRAIN_LLM_STEPS} steps of {TRAIN_LLM_BATCH} x {TRAIN_LLM_SEQ} "
          f"tokens through train_llm (no remat): {wall:.3f} s wall, "
          f"{step_ms:.2f} ms a step = forward {parts['forward']:.2f} + "
          f"backward {parts['backward']:.2f} (plain VJPs "
          f"{parts['vjp']:.2f}, {parts['vjp'] / parts['backward']:.1%} of "
          f"it) + optimizer {parts['optimizer']:.2f} (CUDA events) + host "
          f"batch {parts['batch']:.2f} + copy {parts['copy']:.2f}; "
          f"{tokens * TRAIN_LLM_STEPS / wall:.1f} tokens/s; loss "
          + " -> ".join(f"{x:.4f}" for x in losses)
          + f"; peak memory {peak / 1e9:.2f} GB; launches a step "
          f"{ {k: v // TRAIN_LLM_STEPS for k, v in runs[False].items() if v} }"
          f" [{card}]")
    rstep_ms = rwall * 1e3 / TRAIN_LLM_REMAT_STEPS
    per_step = {k: v // TRAIN_LLM_REMAT_STEPS
                for k, v in runs[True].items() if v}
    print(f"  remat: {TRAIN_LLM_REMAT_STEPS} steps {rstep_ms:.2f} ms a "
          f"step, losses " + ", ".join(f"{x:.6f}" for x in remat_losses)
          + f" ({apart:.2e} from the first run's), peak memory "
          f"{rpeak / 1e9:.2f} GB; launches a step {per_step} [{card}]")
    print(f"  one step under the profiler: {pwall * 1e3:.1f} ms wall, device "
          f"busy {busy:.2f} ms ({busy / (pwall * 1e3):.1%}), "
          f"{sum(e.count for e in avgs if _self_device_us(e) > 0)} device "
          f"kernels/copies; plain VJPs on the device: {vjp_txt} [{card}]")
    print("  top device time: " + "; ".join(
        f"{e.key[:48]} {_self_device_us(e) / 1e3:.3f} ms x{e.count}"
        for e in top) + f" [{card}]")
    return runs, {"step_ms": step_ms, "parts_ms": parts,
                  "tokens_per_s": tokens * TRAIN_LLM_STEPS / wall,
                  "losses": losses, "peak_gb": peak / 1e9,
                  "remat_step_ms": rstep_ms, "remat_peak_gb": rpeak / 1e9,
                  "busy_share": busy / (pwall * 1e3),
                  "vjp_profile_ms": vjp_prof}


# the launcher's path (launch/train.py): make_step's bf16 train step
LAUNCHER_BATCH, LAUNCHER_SEQ, LAUNCHER_STEPS, LAUNCHER_LR = 4, 512, 6, 3e-4
# the card-vs-CPU bf16 step's tokens (the CPU's bf16 step took 39.3 s at
# 256 on the card's host)
LAUNCHER_REF_SEQ = 128


def launcher_cut(card):
    """The deepest block cut of LLM_ARCH at full width whose bf16 train
    step (``launch.specs.make_step``: remat, AdamW; bf16 parameters, float32
    moments) the abstract pass (``roofline.analysis.analyze_step``) puts
    under the card's HBM at LAUNCHER_BATCH x LAUNCHER_SEQ: the peak at one
    and two blocks (it is affine in the blocks), then passes from the
    extrapolated cut down until one fits.  Returns (blocks, that pass's
    report)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import make_step
    from repro_torch.roofline.analysis import analyze_step
    from repro_torch.roofline.hw import H100
    full = get_config(LLM_ARCH)
    shape = ShapeConfig("launcher", LAUNCHER_SEQ, LAUNCHER_BATCH, "train")
    reports = {}

    def report(n):
        if n not in reports:
            cfg = block_cut(full, n)
            fn, args, _, _ = make_step(cfg, shape, lr=LAUNCHER_LR)
            reports[n] = analyze_step(fn, args, arch=cfg.name, shape=shape,
                                      cfg=cfg)
        return reports[n]

    t0 = time.perf_counter()
    p1 = report(1).peak_memory_per_device
    slope = report(2).peak_memory_per_device - p1
    n = max(1, min(full.num_blocks,
                   1 + int((H100.hbm_bytes - p1) // slope)))
    while n > 1 and report(n).peak_memory_per_device > H100.hbm_bytes:
        n -= 1
    rep = report(n)
    print(f"launcher cut: {LLM_ARCH}'s bf16 train step at {LAUNCHER_BATCH} x "
          f"{LAUNCHER_SEQ} peaks at {p1 / 1e9:.2f} GB with one block, "
          f"{slope / 1e9:.3f} GB more a block; {n} blocks "
          f"({len(full.prefix_layers) + n * len(full.block_pattern)} layers) "
          f"peak at {rep.peak_memory_per_device / 1e9:.3f} GB of "
          f"{H100.hbm_bytes / 1e9:.0f} GB ({len(reports)} abstract passes, "
          f"{time.perf_counter() - t0:.1f} s) [{card}]")
    return n, rep


class GradNorms:
    """Wraps ``AdamW.update`` (looked up at call time by make_step's step)
    to record the global norm of each update's gradients and, with
    ``keep``, the gradients themselves (the tree, where they lie)."""

    def __init__(self, keep: bool = False):
        from repro_torch.training.optimizer import AdamW
        self.cls, self.keep, self.norms, self.grads = AdamW, keep, [], []

    def __enter__(self):
        from repro_torch.training.optimizer import global_norm
        self.saved = self.cls.update

        def update(opt, grads, state, params):
            self.norms.append(float(global_norm(grads)))
            if self.keep:
                self.grads.append(grads)
            return self.saved(opt, grads, state, params)
        self.cls.update = update
        return self

    def __exit__(self, *exc):
        self.cls.update = self.saved
        return False


def flat_leaves(tree) -> dict:
    """``{checkpoint key: tensor}`` of a tree, the tensors where they lie
    (``weights.map_with_path``'s keys, as ``weights._flatten``'s)."""
    from repro_torch import weights
    flat = {}
    weights.map_with_path(lambda k, t: flat.__setitem__(k, t), tree)
    return flat


def leaf_l2_err(got, want) -> float:
    """||got - want|| / ||want|| of one gradient leaf, in float64 on
    ``got``'s device: its size and its direction at once (0 where both
    are 0)."""
    got, want = got.double(), want.to(got.device).double()
    diff = float(got.sub(want).norm())
    return diff / float(want.norm()) if diff else 0.0


def bf16_update_ulps(got: dict, want: dict, lr: float) -> tuple:
    """Flat bf16 parameter trees after one optimizer step from the same
    parameters and gradients on two devices, compared on ``got``'s
    device: (the largest difference of an entry in bf16 ulps of the
    larger of the two, after 2^-16 lr of float32 rounding in the update is
    taken off; the share of entries that differ at all)."""
    worst, differ, total = 0.0, 0, 0
    for k, w in want.items():
        a = got[k].float()
        w = w.to(a.device).float()
        if a.shape != w.shape or not bool(a.isfinite().all()):
            raise AssertionError(f"launcher step parameters {k}: shape "
                                 f"{tuple(a.shape)} vs {tuple(w.shape)} or "
                                 f"non-finite")
        diff = (a - w).abs()
        differ, total = differ + int((diff > 0).sum()), total + diff.numel()
        over = (diff - 2.0 ** -16 * lr).clamp(min=0.0)
        ulp = BF16_ULP_OF * a.abs().maximum(w.abs())
        ulps = (over / ulp).masked_fill(over == 0, 0.0)
        worst = max(worst, float(ulps.max()) if ulps.numel() else 0.0)
    return worst, differ / max(1, total)


# a bf16 value's ulp as a share of the value: 2^-7 at most
BF16_ULP_OF = 2.0 ** -7


def phase_llm_launcher_reference(torch, np, card):
    """One bf16 step of the launcher's make_step (remat, AdamW) on
    LLM_ARCH at full width cut to 9 layers, 1 x LAUNCHER_REF_SEQ tokens,
    from the same bf16 weights on the card and the CPU.  The loss and the
    gradients' global norm agree within BF16_LLM_RTOL.  Every gradient
    leaf agrees within BF16_GRAD_RTOL of its own norm
    (:func:`leaf_l2_err`, its size and direction: a missing leaf is 1 off,
    a reversed one 2), and the median leaf's norm within BF16_LLM_RTOL: the
    global norm, which the embedding fills, shows neither.  The
    parameters after the step are bf16 and are what AdamW makes on the CPU
    from the card's own gradients, within one bf16 ulp an entry
    (:func:`bf16_update_ulps`).  Beside it, as a yardstick, the step's
    gradients on the card with K6 and K8 replaced by their plain versions
    (no kernel at all) against the CPU's: the bf16 program's own spread
    between the two devices, which a single bf16 rounding anywhere in the
    9 layers feeds.  The comparisons run on the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.specs import COMPUTE_DTYPE, make_step
    from repro_torch.models import schema as sch
    from repro_torch.models import transformer as tfm
    from repro_torch.testing import (BF16_GRAD_RTOL, BF16_LLM_RTOL,
                                     leaf_rel_err)
    from repro_torch.training import data, train_loop
    from repro_torch.training.optimizer import AdamW, tree_leaves
    cfg = block_cut(get_config(LLM_ARCH), 1)
    step = make_step(cfg, ShapeConfig("t", LAUNCHER_REF_SEQ, 1, "train"),
                     lr=LAUNCHER_LR)[0]
    cpu_params = tfm.init_params(cfg, SEED, "cpu", COMPUTE_DTYPE)
    batch = next(iter(data.TokenStream(cfg.vocab_size, LAUNCHER_REF_SEQ, 1,
                                       SEED)))

    def run(dev):
        params = sch.tree_map(lambda t: t.to(dev), cpu_params)
        t0 = time.perf_counter()
        with GradNorms(keep=True) as tap:
            new, _, m = step(params, AdamW(lr=LAUNCHER_LR).init(params),
                             train_loop.to_device(batch, dev))
            loss = float(m["loss"])
        wall = time.perf_counter() - t0
        return dict(loss=loss, norm=tap.norms[0], grads=tap.grads[0],
                    params=flat_leaves(new),
                    kept=all(t.dtype == COMPUTE_DTYPE
                             for t in tree_leaves(new)), wall=wall)

    card_run, cpu_run = run("cuda"), run("cpu")
    saved = ops.flash_attention, ops.ssd_scan
    ops.flash_attention, ops.ssd_scan = ref.flash_attention, ref.ssd_scan
    try:
        plain_g = flat_leaves(run("cuda")["grads"])
    finally:
        ops.flash_attention, ops.ssd_scan = saved
    g, g0 = flat_leaves(card_run["grads"]), flat_leaves(cpu_run["grads"])
    loss, loss0 = card_run["loss"], cpu_run["loss"]
    norm, norm0 = card_run["norm"], cpu_run["norm"]
    loss_err, norm_err = leaf_rel_err(loss, loss0), leaf_rel_err(norm, norm0)
    same_keys = g.keys() == g0.keys()
    errs = {k: leaf_l2_err(g[k], g0[k]) for k in g0}
    worst = max(errs, key=errs.get)
    plain = {k: leaf_l2_err(plain_g[k], g0[k]) for k in g0}
    plain_worst = max(plain, key=plain.get)
    del plain_g
    norms = [leaf_rel_err(float(g[k].double().norm()),
                          float(g0[k].to(g[k].device).double().norm()))
             for k in g0]
    median_l2 = float(np.median(list(errs.values())))
    median_norm = float(np.median(norms))
    # AdamW on the CPU, from the card's gradients and the same parameters
    opt = AdamW(lr=LAUNCHER_LR)
    want = flat_leaves(opt.update(
        sch.tree_map(lambda t: t.to("cpu"), card_run["grads"]),
        opt.init(cpu_params), cpu_params)[0])
    ulps, differ = bf16_update_ulps(card_run["params"], want, LAUNCHER_LR)
    del want, g, card_run["grads"], card_run["params"]
    torch.cuda.empty_cache()
    print(f"launcher step card vs CPU in bf16, {cfg.name} at full width, 1 x"
          f" {LAUNCHER_REF_SEQ} tokens: loss {loss:.6f} vs {loss0:.6f} "
          f"({loss_err:.2e}), gradient norm {norm:.4f} vs {norm0:.4f} "
          f"({norm_err:.2e}; tolerance {BF16_LLM_RTOL}); {len(errs)} "
          f"gradient leaves within {errs[worst]:.3e} of their norm (worst "
          f"{worst}; median {median_l2:.3e}; BF16_GRAD_RTOL "
          f"{BF16_GRAD_RTOL}), their norms within {max(norms):.3e} (median "
          f"{median_norm:.3e}; tolerance {BF16_LLM_RTOL}); the plain "
          f"program on the card, no kernel, {plain[plain_worst]:.3e} (worst "
          f"{plain_worst}; median "
          f"{float(np.median(list(plain.values()))):.3e}); the card's "
          f"parameters after the step AdamW's on the CPU from its gradients "
          f"within {ulps:.3f} bf16 ulp ({differ:.3e} of the entries differ);"
          f" one step {card_run['wall']:.2f} s on the card, "
          f"{cpu_run['wall']:.2f} s on the CPU [{card}]")
    if not (np.isfinite(loss) and card_run["kept"] and same_keys
            and loss_err <= BF16_LLM_RTOL
            and norm_err <= BF16_LLM_RTOL and errs[worst] <= BF16_GRAD_RTOL
            and median_norm <= BF16_LLM_RTOL and ulps <= 1.0):
        raise AssertionError(f"launcher step card vs CPU: loss {loss} vs "
                             f"{loss0}, gradient norm {norm} vs {norm0}, "
                             f"worst gradient leaf {worst} {errs[worst]:.3e}"
                             f", median leaf norm {median_norm:.3e}, "
                             f"parameters {ulps:.3f} ulp, bf16 parameters "
                             f"kept {card_run['kept']}")
    return {"loss_err": loss_err, "grad_norm_err": norm_err,
            "grad_err": errs[worst], "worst_leaf": worst,
            "grad_err_median": median_l2, "leaf_norm_err": max(norms),
            "leaf_norm_err_median": median_norm, "params_ulps": ulps,
            "params_differ": differ,
            "plain_on_card_grad_err": plain[plain_worst],
            "cpu_s": cpu_run["wall"]}


def phase_llm_launcher(torch, np, card):
    """(c) launch.train's step -- ``launch.specs.make_step`` (remat, AdamW)
    computing in bf16 on bf16 parameters drawn as the launcher draws them
    (``init_params(cfg, 0-seeded, device, bfloat16)``) -- on LLM_ARCH at
    full width cut to the deepest cut that fits (:func:`launcher_cut`),
    LAUNCHER_STEPS steps of LAUNCHER_BATCH x LAUNCHER_SEQ tokens from
    ``TokenStream``.  The first step is the warm-up; the counts are zeroed
    before the rest and read after them.  The loss must be finite and
    fall; K6 and K8 launch as ``train_launches(cfg, remat=True)`` says.
    Returns the counts and a summary."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import COMPUTE_DTYPE, make_step
    from repro_torch.models import transformer as tfm
    from repro_torch.training import data, train_loop
    from repro_torch.training.optimizer import AdamW, tree_leaves
    blocks, rep = launcher_cut(card)
    cfg = block_cut(get_config(LLM_ARCH), blocks)
    tokens = LAUNCHER_BATCH * LAUNCHER_SEQ
    step = make_step(cfg, ShapeConfig("t", LAUNCHER_SEQ, LAUNCHER_BATCH,
                                      "train"), lr=LAUNCHER_LR)[0]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_params(cfg, SEED, "cuda", COMPUTE_DTYPE)
    state = AdamW(lr=LAUNCHER_LR).init(params)
    stream = iter(data.TokenStream(cfg.vocab_size, LAUNCHER_SEQ,
                                   LAUNCHER_BATCH, SEED))
    losses, times = [], []
    for i in range(LAUNCHER_STEPS):
        if i == 1:
            ops.reset_launch_counts()
        batch = train_loop.to_device(next(stream), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))          # synchronises
        times.append(time.perf_counter() - t0)
    counts = {**ops.launch_counts(), **ops.bf16_launch_counts()}
    peak = torch.cuda.max_memory_allocated() - base
    dtypes = {str(t.dtype) for t in tree_leaves(params)}
    del params, state, batch
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"launcher: the loss did not fall: {losses}")
    want = {k: n * (LAUNCHER_STEPS - 1)
            for k, n in train_launches(cfg, True).items()}
    want.update({k: 0 for k in ops.KERNELS
                 if k not in ("flash_attention", "ssd_scan")})
    want.update({k + "_bf16": want[k] for k in ops.KERNELS
                 if k + "_bf16" in ops.BF16})     # every launch a bf16 one
    check_launches(counts, want, "the launcher's bf16 train step")
    step_ms = statistics.mean(times[1:]) * 1e3
    predicted = rep.peak_memory_per_device
    print(f"launcher path: launch.specs.make_step (remat, AdamW lr "
          f"{LAUNCHER_LR}) in bf16 on {cfg.name} at full width, {blocks} "
          f"blocks = {cfg.num_layers} layers, {cfg.param_count() / 1e9:.3f} B"
          f" parameters ({', '.join(sorted(dtypes))}), "
          f"{LAUNCHER_BATCH} x {LAUNCHER_SEQ} tokens: {step_ms:.1f} ms a "
          f"step over {LAUNCHER_STEPS - 1} steps after a warm-up of "
          f"{times[0] * 1e3:.1f} ms, {tokens / step_ms * 1e3:.1f} tokens/s; "
          f"loss " + " -> ".join(f"{x:.4f}" for x in losses)
          + f"; peak {peak / 1e9:.3f} GB against {predicted / 1e9:.3f} GB "
          f"predicted ({peak / predicted:.4f}); launches a step "
          f"{ {k: v // (LAUNCHER_STEPS - 1) for k, v in counts.items() if v} }"
          f" [{card}]")
    return counts, {"blocks": blocks, "layers": cfg.num_layers,
                    "params": cfg.param_count(), "step_ms": step_ms,
                    "tokens_per_s": tokens / step_ms * 1e3,
                    "losses": losses, "peak_bytes": peak,
                    "predicted_peak_bytes": predicted}


def dryrun_card_table(shapes=None, arch: str = DRYRUN_ARCH) -> dict:
    """The abstract passes that phase_dryrun_card reads: ``arch`` at
    ``shapes`` (every input shape where None), in this process."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch.dryrun import run_one
    return {(arch, s): run_one(arch, s, device="meta", verbose=False,
                               save=False)
            for s in shapes or INPUT_SHAPES}


def phase_gemma2(torch, np, card):
    """gemma2-9b's card phases alone (``--only gemma2``): its bf16 dry-run
    steps, K6 and K7 at its 32k shapes against their plain versions, its
    one-block bf16 cut and its two-block float32 cut against the CPU, and
    its float32 serving path."""
    gemma = phase_dryrun_card(torch, card, dryrun_card_table(
        arch=GEMMA_ARCH), GEMMA_ARCH)
    phase_gemma2_32k(torch, card, {s: gemma[s]["batch"]
                                   for s in DRYRUN_CARD_SHAPES}, check=True)
    phase_dryrun_reference(torch, np, card, GEMMA_ARCH)
    phase_gemma2_reference(torch, np, card)
    phase_llm_main_path(torch, np, card, GEMMA_ARCH)


# --only: phases run alone after the build, each with (torch, np, card)
ONLY_PHASES = {
    "split": lambda torch, np, card: phase_llm_kernel_split(
        torch, card, card_batches(dryrun_card_table(DRYRUN_CARD_SHAPES))),
    "k6": phase_flash_attention,
    "k7": phase_decode_attention,
    "k8": phase_ssd_scan,
    "dryrun_kernels": lambda torch, np, card: phase_dryrun_kernels(
        torch, np, card,
        card_batches(dryrun_card_table(DRYRUN_CARD_SHAPES))),
    "dryrun_steps": lambda torch, np, card: phase_dryrun_card(
        torch, card, dryrun_card_table()),
    "k7_host": lambda torch, np, card: relay_probes(ROOT, "this tree",
                                                    ["phase_k7_host"]),
    "decode_step": lambda torch, np, card: relay_probes(
        ROOT, "this tree", ["phase_decode_step"]),
    "gemma2_32k": lambda torch, np, card: relay_probes(
        ROOT, "this tree", ["phase_gemma2_32k"]),
    "gemma2": phase_gemma2,
    "gemma2_serve": lambda torch, np, card: relay_probes(
        ROOT, "this tree", ["phase_gemma2_serve"]),
}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout (e.g. the parent commit from git "
                         "archive): its K2, K5, K1, K4b and K4a phases, and "
                         "its K6, K7 and K8 phases, run before and after "
                         "this tree's, on the same card")
    ap.add_argument("--only", nargs="+", choices=sorted(ONLY_PHASES),
                    help="build, then run only these phases and stop (no "
                         "contract line); with --parent the parent's K6 / "
                         "K7 / K8 rows (k6, k7, k8) and this script's "
                         "probes on its package (k7_host, decode_step, "
                         "gemma2_32k, gemma2_serve) run before and after")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit("chip_smoke.py: src/repro_torch not found next to "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, SRC)
    # the dry run's bf16 steps fill the card to within a few GB of the
    # abstract pass's peak; with fixed segments the caching allocator's
    # fragmentation (9.4 GB reserved but unallocated at zamba2's 6-row
    # prefill_32k) ran it out of memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False;"
                         " this check runs only on the card")
    from repro_torch import set_reference_precision
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    set_reference_precision()
    _build.library()
    print(f"built {_build.build()} in "
          f"{time.perf_counter() - t_start:.1f} s [{card}]")
    for line in ptxas_summary(_build.build_log):
        print(f"  {line}")

    if args.only:
        probes = [f"phase_{n}" for n in args.only if f"phase_{n}" in PROBES]

        def relay(when):
            if args.parent and set(PARENT_LLM) & set(args.only):
                relay_parent_llm(args.parent, when, args.only)
            if args.parent and probes:
                relay_probes(args.parent, f"parent ({when} this tree's)",
                             probes)
        relay("before")
        for name in args.only:
            ONLY_PHASES[name](torch, np, card)
        relay("after")
        print(f"chip_smoke.py --only {' '.join(args.only)} finished in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    before = parent_device_ms(args.parent, card) if args.parent else None
    crop_row = phase_crop_gather(torch, np, card)
    update_rows = phase_onevsall_update(torch, np, card)
    filter_row = phase_region_filter(torch, np, card)
    frame_row = phase_frame_filter(torch, np, card)
    iou_rows = phase_iou_matrix(torch, np, card)
    after = parent_device_ms(args.parent, card) if args.parent else None
    for tag, row in ([("K2", crop_row)] + [("K5", r) for r in update_rows]
                     + [("K1", filter_row), ("K4b", frame_row)]
                     + [("K4a", r) for r in iou_rows]):
        key = parent_key(tag, row["shape"])
        row["parent_device_ms"] = (None if before is None
                                   else [before.get(key), after.get(key)])
        ratio = ("" if before is None or not (
            before.get(key) and after.get(key) and row["device_ms"]) else
            f", {row['device_ms'] / before[key]:.3f} and "
            f"{row['device_ms'] / after[key]:.3f} of the parent's")
        print(f"{tag} {row['shape']}: parent's device time "
              + ("not measured (no --parent)" if before is None else
                 f"{before.get(key)} ms before, {after.get(key)} ms after "
                 f"this tree's, this tree {fmt(row['device_ms'])}{ratio}")
              + f" [{card}]")
    update_row = phase_onevsall_replay(torch, np, card)
    update_row["update_shapes"] = update_rows
    video_rows = [filter_row, crop_row, phase_onevsall(torch, np, card)]
    iou_row = iou_rows[0]                   # the flush's NMS shape
    iou_row["other_shapes"] = iou_rows[1:]
    if args.parent:
        relay_parent_llm(args.parent, "before")
    llm_rows = [phase_flash_attention(torch, np, card),
                phase_decode_attention(torch, np, card),
                phase_ssd_scan(torch, np, card)]
    if args.parent:
        relay_parent_llm(args.parent, "after")
    nms_row = phase_nms(torch, np, card)
    phase_reference(torch, np, card)
    fused_counts, sync_counts, runs, served = phase_main_path(torch, np, card)
    random_f1 = {name: out.f1["f1"] for name, out in runs["fused"][1].items()}
    phase_region_filter_served(torch, card, served[0], filter_row)
    phase_nms_served(torch, card, served[1], nms_row)
    for row in video_rows + [iou_row, nms_row]:
        row["launches"] = fused_counts[row["name"]]
        row["launches_sync"] = sync_counts[row["name"]]
    phase_baselines_reference(torch, np, card)
    base_counts = phase_baselines_main_path(torch, np, card)
    for row in (iou_row, nms_row):
        row["launches_baselines"] = {
            name: c[row["name"]] for name, c in base_counts.items()}
    frame_row["launches"] = base_counts["dds"]["region_filter_mask"]
    phase_learning_reference(torch, np, card)
    learn_counts = phase_learning_main_path(torch, np, card)
    update_row.update(launches=learn_counts["onevsall_update"],
                      launches_replay=learn_counts["onevsall_replay"],
                      steps=learn_counts["onevsall_steps"],
                      launches_inline=learn_counts["inline_launches"],
                      steps_inline=learn_counts["inline_steps"])
    iou_row["launches_learning"] = learn_counts["iou_matrix"]
    nms_row["launches_learning"] = learn_counts["nms_greedy"]
    filter_row["launches_learning"] = learn_counts["region_filter_mask_batch"]
    phase_training_reference(torch, np, card)
    trained = phase_training(torch, np, card)
    phase_trained_video(torch, np, card, trained, random_f1)
    phase_baselines_main_path(torch, np, card,
                              (trained["detector"], trained["classifier"]))
    phase_trained_learning(torch, np, card, trained)
    served = (trained["detector"], trained["classifier"])
    phase_shard_oracle(torch, np, card, served)
    shard_counts = phase_sharded(torch, np, card, served)
    phase_steal_outage(torch, np, card, served)
    tenancy_counts = phase_tenancy(torch, np, card, served)
    for row in video_rows + [iou_row, nms_row]:
        row["launches_sharded"] = shard_counts[row["name"]]
        row["launches_tenancy"] = tenancy_counts[row["name"]]
    del trained, served
    dryrun = phase_dryrun(torch, np, card)
    phase_llm_reference(torch, np, card)
    llm_counts, llm_cfg, llm_params, _ = phase_llm_main_path(torch, np, card)
    cascade_counts = phase_cascade(torch, np, card, llm_cfg, llm_params)
    del llm_params
    torch.cuda.empty_cache()
    phase_cascade_reference(torch, np, card)
    # the MoE + MLA and cross-attention paths, once zamba2's weights are
    # freed: deepseek-v2-lite's 61.9 GB leave ~18 GB of the card
    checks = {MOE_ARCH: phase_moe_reference(torch, np, card),
              CROSS_ARCH: phase_cross_reference(torch, np, card),
              GEMMA_ARCH: phase_gemma2_reference(torch, np, card)}
    moe_counts, _, moe_params, _ = phase_llm_main_path(torch, np, card,
                                                    MOE_ARCH)
    del moe_params
    torch.cuda.empty_cache()
    cross_counts = phase_cross_main_path(torch, np, card)
    # gemma2-9b (LOCAL / global attention, softcaps, d = 256) served in
    # float32 once musicgen's weights are freed: its 37 GB
    gemma_counts, _, gemma_params, _ = phase_llm_main_path(torch, np, card,
                                                        GEMMA_ARCH)
    del gemma_params
    torch.cuda.empty_cache()
    # LLM training, once deepseek's and musicgen's weights are freed
    grads = phase_llm_grad(torch, np, card)
    checks["llm_train_step"] = phase_llm_train_reference(torch, np, card)
    train_counts, train_split = phase_llm_train_main_path(torch, np, card)
    # the launcher's bf16 path, deepest that fits, last: the whole card
    checks["launcher_step_bf16"] = phase_llm_launcher_reference(torch, np,
                                                                card)
    launcher_counts, launcher = phase_llm_launcher(torch, np, card)
    bf16_rows = []
    for row in llm_rows:
        row["launches"] = llm_counts[row["name"]]
        if row["name"] in ("flash_attention", "ssd_scan"):
            row["launches_cascade"] = cascade_counts[row["name"]]
            row["launches_training"] = {
                "no_remat": train_counts[False][row["name"]],
                "remat": train_counts[True][row["name"]]}
            row["vjps_training"] = {
                "no_remat": train_counts[False][row["name"] + "_vjp"],
                "remat": train_counts[True][row["name"] + "_vjp"]}
            row["gradient"] = grads[row["name"]]
        row["launches_deepseek"] = moe_counts[row["name"]]
        row["launches_musicgen"] = cross_counts[row["name"]]
        row["launches_gemma2"] = gemma_counts[row["name"]]
        if row["name"] == "flash_attention":
            row["dryrun_shape"] = dryrun["kernels"]["flash_attention_fp32"]
        # the bf16 entry (a kernel line of its own): its launches are the
        # bf16 paths' (the dry run's steps and the launcher's training)
        bf = row.pop("bf16")
        bf["name"] = row["name"] + "_bf16"
        bf["launches_dryrun"] = {s: dryrun["card"][s]["launches"][
            bf["name"]] for s in DRYRUN_CARD_SHAPES}
        bf["launches_dryrun_gemma2"] = {s: dryrun["card_gemma2"][s][
            "launches"][bf["name"]] for s in DRYRUN_CARD_SHAPES}
        bf["launches"] = sum(bf["launches_dryrun"].values()) + sum(
            bf["launches_dryrun_gemma2"].values())
        bf["launches_launcher"] = launcher_counts[bf["name"]]
        if row["name"] in ("flash_attention", "ssd_scan"):
            bf["vjps_launcher"] = launcher_counts[row["name"] + "_vjp"]
        bf["dryrun_shape"] = dryrun["kernels"][row["name"]]
        tag = {"flash_attention": "K6", "decode_attention": "K7"}.get(
            row["name"])
        if tag:
            bf["dryrun_gemma2"] = {
                key: r for key, r in dryrun["kernels"]["gemma2"].items()
                if key.startswith(tag)}
        # K7's and K8's split by device kernel, at 32k and serving shapes
        tag = {"decode_attention": "K7", "ssd_scan": "K8"}.get(row["name"])
        for r, dt in ((row, "float32"), (bf, "bf16")):
            if tag:
                r["split_ms"] = {
                    key: split for key, split in
                    dryrun["kernels"]["split"].items()
                    if key.startswith(f"{tag} {dt} ")}
        bf16_rows.append(bf)
    rows = (video_rows + [iou_row, nms_row, frame_row, update_row] + llm_rows
            + bf16_rows)
    print(f"chip_smoke.py finished its checks in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows, "card": card,
                      "llm_card_vs_cpu": checks,
                      "llm_training": train_split,
                      "llm_launcher_bf16": launcher,
                      "dryrun": {k: dryrun[k] for k in
                                 ("table", "card", "card_vs_cpu",
                                  "card_gemma2", "card_vs_cpu_gemma2")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
