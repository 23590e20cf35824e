#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at its path's shapes,
and times kernel, plain version and a library yardstick with CUDA events.
It then drives four paths with the kernels' launch counts zeroed just
before and read just after each: the full-width video path
(``MultiStreamCoordinator`` with the ``vpaas_video`` models) on both hot
paths; the paper's comparison baselines (MPEG, Glimpse, CloudSeg, DDS)
beside VPaaS through ``default_policies()`` on the same models; the
continual-learning path on the same models (the per-site
``ContinualLearningPlane`` of ``serve --per-site-learning
--ensemble-serving``, whose background trainer runs every proximal step
through the update kernel, then the inline ``IncrementalLearner``); and
the LLM path (``LLMServer`` over full-width ``zamba2-7b``).  Weights are
random from a seed.  Each path's outputs are checked against the port's
CPU path (the kernels' plain versions) on a small input: one video chunk,
the four baselines on 2 chunks x 4 frames of each content type, a
2-stream learning run, and ``zamba2-7b`` cut to 9 layers.  Any failed
check raises; nothing is caught.  The last three lines are the card's name
and power limit, one JSON object describing the kernels, and
``{"ok": true, "device": {...}}``.

``--parent DIR`` names another checkout (the parent commit unpacked with
``git archive``): its K2 and K5 phases then run in a subprocess before and
after this tree's, on the same card, and their device times are printed
beside this tree's.

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

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside the
# tensor cores and dense TF32 on them -- the rates the bounds below divide by
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

SEED = 0

# the kernels the video path runs (K4a through its two NMS per flush)
VIDEO_KERNELS = ("region_filter_mask_batch", "crop_gather", "onevsall_scores",
                 "iou_matrix")


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tc_bound_ms(nbytes: float, mma_flops: float, simt_ops: float):
    """The bound of a kernel whose products run on the tensor cores in
    3xTF32 (three TF32 products for each fp32 one) and the rest on the CUDA
    cores: the larger of the bytes' time and the two units' times summed."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * mma_flops / TF32_FLOP_PER_S + simt_ops / FP32_FLOP_PER_S
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


def device_us_per_call(avgs, reps: int, once: bool = False) -> float:
    """Device time of one call from a profile of ``reps`` identical calls:
    each kernel's mean duration times its launches per call, rounded to a
    whole number.  The profiler can drop a few kernel events of a window
    (3 of 20 in a run of K7, 3 of 30 of K8); dividing the plain sum by
    ``reps`` would count them as time the card did not spend.  With
    ``once`` (a call known to launch each of its kernels once) it is the
    sum of the kernels' mean durations, whatever share of the events the
    profiler kept (on an H100 it once kept 6 of 30 events of a K5 run)."""
    total = 0.0
    for e in avgs:
        us = _self_device_us(e)
        if us > 0:
            per_call = 1 if once else (round(e.count / reps)
                                       or e.count / reps)
            total += us / e.count * per_call
    return total


def profile_device(torch, fn, reps: int = 1, once: bool = False):
    """Run ``fn`` ``reps`` times under torch.profiler (CUPTI); return the
    device time per call in ms and the key averages (None when the
    profiler recorded no device time); ``once`` as in
    :func:`device_us_per_call`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    total_us = device_us_per_call(avgs, reps, once)
    return (total_us / 1e3 if total_us > 0 else None), avgs


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


def _report_turns(tag, turns, lib_timed, lib_name, card):
    k, lib = turns["kernel"], turns["library"]
    print(f"{tag} in turns (kernel, {lib_name}, {lib_name}, kernel): kernel "
          f"{k[0]:.4f}, {k[1]:.4f} ms per call; {lib_name} {lib[0]:.4f}, "
          f"{lib[1]:.4f} ms per call ({fmt(lib_timed[1])} on the device) "
          f"[{card}]")


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def ptxas_summary(build_log: str):
    """One line per compiled kernel: its name with the template arguments,
    then ptxas's register, barrier, shared-memory and spill report."""
    import re
    name, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?([a-z][a-z_]*_kernel)"
                      r"(?:I((?:L[ib]-?\d+E)+)E)?", line)
        if m:
            args = re.findall(r"L[ib](-?\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
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


def _report(tag, row, card, lib_name=None):
    lib = ("" if lib_name is None else
           f", {lib_name} {fmt(row['library_ms'])}")
    print(f"{tag}: kernel {fmt(row['ms'])} per call "
          f"({fmt(row['device_ms'])} on the device), plain "
          f"{fmt(row['plain_ms'])} ({fmt(row['plain_device_ms'])} on the "
          f"device){lib}, bound {row['bound_ms']:.6f} ms ({row['bound_by']})"
          f" [{card}]")


def phase_region_filter(torch, np, card):
    from repro_torch.kernels import iou_filter as ik
    from repro_torch.testing import rand_boxes
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
    timed = measure(torch, lambda: ik.region_filter_mask_batch(
        prop, pv, acc, av, loc, **kw))
    plain = measure(torch, lambda: ik.region_filter_mask_batch_ref(
        prop, pv, acc, av, loc, **kw))
    pairs = int(av.sum()) * n          # the kernel skips invalid accepted
    nbytes = f * n * (16 + 1 + 4 + 1) + f * m * (16 + 1)
    ops = 14 * pairs + 5 * f * (n + m) + 5 * f * n
    row = _row("region_filter_mask_batch", "src/repro_torch/csrc/iou_filter.cu",
               "src/repro/kernels/iou_filter.py:174", f"F={f} N={n} M={m}",
               0.0, timed, plain, None, nbytes, ops)
    _report(f"K1 region_filter_mask_batch F={f} N={n} M={m}: masks equal",
            row, card)
    return row


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
        _report_turns(tag, turns, lib, "grid_sample", card)
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
        _report(f"{tag}: max abs err {err:.3e}", row, card,
                "sigmoid(mm)" if g == 1 else None)
        if g == 1:                          # the full-budget classify batch
            _report_turns(tag, turns, lib, "sigmoid(mm)", card)
            row.update(library_device_ms=lib[1], turns_ms=turns,
                       host_us=phase_k3_host_path(torch, np, card))
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
        _report_turns(tag, turns, lib, "addmm composition", card)
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
    from repro_torch.kernels import iou_matrix as im
    from repro_torch.testing import iou_case
    main_row = None
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
        timed = measure(torch, lambda: im.iou_matrix(a, c))
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
        if main_row is None:                # the flush's NMS shape
            main_row = row
    return main_row


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
        timed = measure(torch, lambda: rf.region_filter_mask(*args,
                                                             **FILTER_KW))
        plain = measure(torch, lambda: rf.region_filter_mask_ref(
            *args, **FILTER_KW))
        pairs = int(args[3].sum()) * n     # the kernel skips invalid boxes
        nbytes = n * (16 + 1 + 4 + 1) + m * (16 + 1)
        ops = 14 * pairs + 5 * (n + m) + 5 * n
        row = _row("region_filter_mask", "src/repro_torch/csrc/iou_filter.cu",
                   "src/repro/kernels/iou_filter.py:99", f"N={n} M={m}", 0.0,
                   timed, plain, None, nbytes, ops)
        _report(f"K4b region_filter_mask N={n} M={m}: masks equal", row,
                card)
        if main_row is None:                # the region budget
            main_row = row
    return main_row


def phase_nms(torch, np, card):
    """Greedy NMS at the fused flush's shape: ``ops.nms_mask`` (K4a, then
    the plain greedy loop) beside the plain ``ref.nms_mask``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.testing import rand_boxes
    f, n = 32, 256
    rng = np.random.default_rng(SEED + 3)
    boxes = torch.as_tensor(rand_boxes(rng, (f, n)), device="cuda")
    scores = torch.as_tensor(rng.random((f, n), dtype=np.float32),
                             device="cuda")
    valid = torch.as_tensor(rng.random((f, n)) > 0.5, device="cuda")
    got = ops.nms_mask(boxes, scores, valid)
    if not torch.equal(got, ref.nms_mask(boxes, scores, valid)):
        raise AssertionError("NMS through K4a differs from the plain NMS")
    # in turns (kernel, plain, plain, kernel): the greedy loop is
    # host-bound, and the host's speed drifts within a run
    fns = {"ops.nms_mask (K4a + greedy loop)": ops.nms_mask,
           "ref.nms_mask (plain)": ref.nms_mask}
    times = in_turns({what: (lambda fn=fn: fn(boxes, scores, valid))
                      for what, fn in fns.items()},
                     lambda fn: time_ms(torch, fn, reps=10, warmup=2))
    for what, fn in fns.items():
        dev, _ = profile_device(torch, lambda: fn(boxes, scores, valid))
        print(f"{what}, {n} greedy steps, F={f} N={n}: "
              f"{statistics.mean(times[what]):.3f} ms per call (two turns: "
              f"{', '.join(f'{t:.3f}' for t in times[what])}; {fmt(dev)} on "
              f"the device); masks equal [{card}]")


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


def run_path(torch, np, hot_path, params, streams):
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro_torch.core.coordinator import MultiStreamCoordinator
    from repro_torch.core.protocol import HighLowProtocol
    from repro_torch.kernels import ops
    det_params, clf_params = params
    multi = MultiStreamCoordinator(
        HighLowProtocol(DETECTOR, CLASSIFIER, device="cuda"), det_params,
        clf_params, streams, max_batch_chunks=len(streams),
        batch_window=0.05, hot_path=hot_path, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = multi.run(learn=False)
    torch.cuda.synchronize()
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
    for hot_path in ("fused", "sync"):
        multi, out, results, counts, wall = run_path(torch, np, hot_path,
                                                     params, streams)
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
    for name in ("region_filter_mask_batch", "onevsall_scores", "iou_matrix"):
        if sync_counts[name] == 0:
            raise AssertionError(f"sync path launched no {name} kernel")
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
    return fused_counts, sync_counts, runs


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


def phase_baselines_main_path(torch, np, card):
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro_torch.core.protocol import detections_for_metrics
    from repro_torch.serving.policies import default_policies
    from repro_torch.video.metrics import F1Accumulator
    params = video_params(torch, "cuda")
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
          f"policies of default_policies(); F1 against the synthetic ground "
          f"truth is meaningless with random weights [{card}]")
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
    print(f"baselines card vs CPU reference, MPEG / Glimpse / CloudSeg / DDS "
          f"x {REF_CHUNKS} chunks x {REF_FRAMES} frames of each content type "
          f"at full width: "
          f"{compared} chunk results equal (valid, labels, cloud frames and "
          f"rounds; boxes within MODEL_ATOL, bytes and latencies within "
          f"their tolerances; {exempt_n} tie position(s) exempt, {flips} "
          f"codec call(s) with a half-step tie); card launches K4a "
          f"{launches['iou_matrix']}, K4b {launches['region_filter_mask']} "
          f"[{card}]")


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


def run_learning(torch, device, params, streams, cfg, *, inline=False):
    """One forced-adapt run of the continual-learning plane (or, with
    ``inline``, of per-stream IncrementalLearners and no plane) on
    ``device``; launch counts zeroed just before the run, read just after
    (K5's replays and steps beside them, as ``onevsall_replay`` and
    ``onevsall_steps``)."""
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
    if plane is not None:
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
          f"{counts['region_filter_mask_batch']}, K3 "
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
# the LLM path's kernels: K6 flash attention, K7 decode attention, K8 SSD
# ---------------------------------------------------------------------------
def _attn_ops_per_pair(d, softcap):
    # q.k and p.v (2d each), scale, running max, exp, sum; softcap adds a
    # division, a tanh and a multiply
    return 4 * d + 5 + (3 if softcap else 0)


def phase_flash_attention(torch, np, card):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.testing import ATTN_ATOL, attention_case
    main_row = None
    # the zamba2 cache prefill (a 384-token prompt against the 512-slot
    # cache, q_offset 0), then a GQA / window / softcap case at d = 256
    for b, s_q, s_kv, n_q, n_kv, d, window, cap in (
            (1, 384, 512, 32, 32, 112, None, None),
            (1, 384, 512, 32, 16, 256, 64, 50.0)):
        q, k, v = (torch.as_tensor(a, device="cuda") for a in
                   attention_case(b, s_q, s_kv, n_q, n_kv, d, seed=SEED))
        off = torch.zeros((), dtype=torch.int32, device="cuda")
        kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= ATTN_ATOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K6 at d={d}: max abs error {err} exceeds "
                                 f"{ATTN_ATOL}")
        kernel = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = measure(torch, lambda: fa.flash_attention_ref(q, k, v, **kw))
        lib = turns = None
        if cap is None and window is None:
            # the same function: causal from the top-left corner is
            # q_offset 0; (b, heads, seq, d) layout made outside the timing
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            timed, lib, turns = versus_library(
                torch, kernel, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
        else:
            timed = measure(torch, kernel)
        qp = np.arange(s_q)[:, None]
        kp = np.arange(s_kv)[None, :]
        mask = qp >= kp
        if window is not None:
            mask &= qp - kp < window
        pairs = int(mask.sum()) * b
        keys = int(mask.any(0).sum())            # cache rows any query reads
        nbytes = 4 * (2 * b * s_q * n_q * d + 2 * b * keys * n_kv * d) + 4 * b
        ops = pairs * n_q * _attn_ops_per_pair(d, cap)
        row = _row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:86",
                   f"b={b} s_q={s_q} s_kv={s_kv} heads={n_q}/{n_kv} d={d} "
                   f"window={window} softcap={cap}", err, timed, plain,
                   None if lib is None else lib[0], nbytes, ops)
        tc = ""
        if d <= fa.MMA_HEAD_DIM:
            # the products (QK^T and PV, 4d per pair) on the tensor cores in
            # 3xTF32, the softmax on the CUDA cores
            row["bound_tc_ms"], row["bound_tc_by"] = tc_bound_ms(
                nbytes, pairs * n_q * 4 * d,
                pairs * n_q * (_attn_ops_per_pair(d, cap) - 4 * d))
            tc = (f", tensor-core bound {row['bound_tc_ms']:.6f} ms "
                  f"({row['bound_tc_by']})")
        tag = (f"K6 flash_attention s_q={s_q} s_kv={s_kv} {n_q}/{n_kv} heads "
               f"d={d} window={window} softcap={cap}")
        _report(f"{tag}: max abs err {err:.3e}{tc}", row, card,
                "sdpa" if lib is not None else None)
        if turns is not None:
            _report_turns(tag, turns, lib, "sdpa", card)
            row.update(library_device_ms=lib[1], turns_ms=turns)
        if main_row is None:
            main_row = row
    return main_row


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


def decode_nbytes(b, n_q, n_kv, d, lens, S, window) -> int:
    """Bytes K7's function must move: q and the output, each valid K and V
    row once, the lengths."""
    rows = decode_rows(lens, S, window)
    return 4 * (2 * b * n_q * d + 2 * rows * n_kv * d) + 4 * b


def phase_decode_attention(torch, np, card):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.testing import ATTN_ATOL, decode_case
    main_row = None
    # four slots at the main path's decode lengths, then GQA / window /
    # softcap at d = 256
    for b, S, n_q, n_kv, d, clen, window, cap in (
            (4, 512, 32, 32, 112, [385, 390, 395, 399], None, None),
            (4, 512, 32, 16, 256, [385, 390, 395, 399], 64, 50.0)):
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
        lib = turns = sdpa_kernels = None
        if cap is None and window is None:
            valid = (torch.arange(S, device="cuda")[None, :]
                     < cl[:, None].long())[:, None, None, :]
            qt = q[:, :, None, :]
            kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=valid)
            timed, lib, turns = versus_library(torch, kernel, sdpa)
            # SDPA picks its backend itself for an fp32 boolean mask
            sdpa_kernels = device_kernels(profile_device(torch, sdpa, 10)[1],
                                          10)[0]
        else:
            timed = measure(torch, kernel)
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
        per, nsplit = da.splits(b, S, n_kv, window)
        row.update(splits=nsplit, device_kernels_per_call=per_call)
        tag = (f"K7 decode_attention b={b} S={S} {n_q}/{n_kv} heads d={d} "
               f"window={window} softcap={cap}")
        _report(f"{tag}: max abs err {err:.3e}, {nsplit} splits of {per} "
                f"slots, {per_call:g} device kernels per call "
                f"({', '.join(n[:40] for n, _ in names)})", row, card,
                "sdpa" if lib is not None else None)
        if turns is not None:
            _report_turns(tag, turns, lib, "sdpa", card)
            print("  sdpa's device kernels: " + "; ".join(
                f"{n[:80]} x{c:g}" for n, c in sdpa_kernels))
            row.update(library_device_ms=lib[1], turns_ms=turns,
                       library_kernels=[n for n, _ in sdpa_kernels])
        if main_row is None:
            main_row = row
    return main_row


def ssd_ops(b, s, h, p, n) -> int:
    """Floating-point operations the SSD scan's function needs: the plain
    recurrence, per (row, head, step), the decay exp(dt A), u = dt x (p),
    the state update S <- exp(dt A) S + u B^T (3pn) and y = C S (2pn).  The
    chunked form the kernel runs does more; it is the TPU kernel's choice
    for its matrix units, not what the function costs."""
    return b * h * s * (5 * p * n + p + 2)


def ssd_tc_ops(b, s, h, p, n, chunk):
    """(matrix-product flops, other flops) of the chunked form K8 runs on
    the tensor cores: per (row, head), C B^T and W U on each chunk's causal
    triangle (2n and 2p per pair), the chunk states U^T (B o decay) and the
    incoming C S^T (2pn per step each); besides them the decay weights
    (a difference, an exp and a product per pair), per step u = x dt and
    its decay (2p), exp(cum_i) C S added to y (2p), the cumsum and decays
    (5), and the recurrence across chunks (2pn per chunk)."""
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    pairs = sum(n_ * (n_ + 1) // 2 for n_ in lens)
    mma = b * h * (2 * (n + p) * pairs + 4 * s * p * n)
    other = b * h * (3 * pairs + s * (4 * p + 5) + 2 * p * n * len(lens))
    return mma, other


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
        nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                      + (2 if init else 1) * b * h * p * n)
        row = _row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan.py:74",
                   f"b={b} s={s} h={h} p={p} n={n} chunk={chunk} "
                   f"initial_state={init} weak_decay={weak}", err, timed,
                   plain, None, nbytes, ssd_ops(b, s, h, p, n))
        mma, other = ssd_tc_ops(b, s, h, p, n, chunk)
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
    return main_row


PARENT_PHASES = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch import set_reference_precision
set_reference_precision()
card = cs.card_line()
cs.phase_crop_gather(torch, np, card)
cs.phase_onevsall_update(torch, np, card)
"""


def parent_device_ms(root: str, card: str):
    """Run the K2 and K5 phases of another checkout (the parent commit,
    unpacked with ``git archive``) in a subprocess on this card; relay its
    lines and return {("K2" or "K5", "B=..."): device ms per call}."""
    import re
    code = PARENT_PHASES.format(root=os.path.abspath(root),
                                src=os.path.join(os.path.abspath(root),
                                                 "src"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"the parent's K2/K5 phases failed:\n"
                           f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    found = {}
    for line in run.stdout.splitlines():
        m = re.match(r"(K[25]) \w+ (B=\d+)[^:]*: .*?ms per call "
                     r"\((\d+\.\d+) ms on the device", line)
        if m:
            print(f"  parent: {line}")
            found.setdefault((m.group(1), m.group(2)), float(m.group(3)))
    return found


# ---------------------------------------------------------------------------
# the LLM serving path: full-width zamba2-7b behind LLMServer
# ---------------------------------------------------------------------------
LLM_ARCH = "zamba2-7b"
LLM_SLOTS, LLM_MAX_SEQ, LLM_REQUESTS, LLM_PROMPT, LLM_NEW = 4, 512, 8, 384, 16


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


def phase_llm_main_path(torch, np, card):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import schema as sch
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.server import LLMServer
    cfg = get_config(LLM_ARCH)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    nbytes = sch.param_bytes(tfm.model_schema(cfg))
    print(f"{LLM_ARCH} at full width: {nbytes / 4e9:.3f} B parameters, "
          f"{nbytes / 1e9:.2f} GB float32, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
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
    n_shared = cfg.num_blocks            # one shared-attention occurrence
    n_ssm = len(cfg.prefix_layers) + cfg.num_blocks * sum(
        k == "ssm" for k in cfg.block_pattern)
    want = {"flash_attention": n_shared * prefills,
            "decode_attention": n_shared * steps,
            "ssd_scan": n_ssm * prefills}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"LLM path launched {name} {counts[name]} "
                                 f"times, expected {n}")
    tokens = sum(len(r.output) for r in finished)
    pre, dec = timer.times["prefill"], timer.times["decode_step"]
    print(f"LLM main path: {LLM_ARCH} full width, {LLM_SLOTS} slots, "
          f"max_seq {LLM_MAX_SEQ}, {LLM_REQUESTS} requests x {LLM_PROMPT}"
          f"-token prompts x {LLM_NEW} new tokens: {wall:.3f} s wall, "
          f"{tokens} tokens, {tokens / wall:.2f} tokens/s; prefill "
          f"{statistics.median(pre) * 1e3:.2f} ms per request (median of "
          f"{prefills}, min {min(pre) * 1e3:.2f}), decode "
          f"{statistics.median(dec) * 1e3:.2f} ms per step (median of "
          f"{steps}, min {min(dec) * 1e3:.2f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{ {k: counts[k] for k in want} } [{card}]")
    profile_llm(torch, np, card, cfg, params)
    del params, server
    torch.cuda.empty_cache()
    return counts


def profile_llm(torch, np, card, cfg, params):
    """Where one prefill and one 4-slot decode step spend the card's time
    (their wall time is inflated by the tracing; the shares count)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tfm
    from repro_torch.serving.kv_cache import CachePool
    pool = CachePool(cfg, LLM_SLOTS, LLM_MAX_SEQ, "cuda")
    toks = torch.as_tensor(llm_requests(np, cfg, 1, LLM_PROMPT, 1)[0].prompt,
                           device="cuda")[None]
    last = torch.zeros((LLM_SLOTS, 1), dtype=torch.long, device="cuda")
    idx = torch.full((LLM_SLOTS,), LLM_PROMPT, device="cuda")
    for what, fn in (
            ("prefill", lambda: tfm.prefill(
                cfg, params, toks, tfm.init_cache(cfg, 1, LLM_MAX_SEQ,
                                                  "cuda"))),
            ("decode step", lambda: tfm.decode_step(cfg, params, last,
                                                    pool.cache, idx))):
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
        print(f"LLM {what} under the profiler: {wall * 1e3:.1f} ms wall, "
              f"device busy {busy:.2f} ms ({busy / (wall * 1e3):.1%}), "
              f"{sum(e.count for e in avgs if _self_device_us(e) > 0)} device "
              f"kernels/copies [{card}]")
        print("  top device time: " + "; ".join(
            f"{e.key[:48]} {_self_device_us(e) / 1e3:.3f} ms x{e.count}"
            for e in top))


def phase_llm_reference(torch, np, card):
    """zamba2-7b at full width cut to 9 layers (the prefix and one block),
    the same weights on the card and on the CPU: prefill logits of four
    40-token prompts, then six teacher-forced lockstep decode steps through
    a 4-slot pool with per-slot cache indices, the server's calls."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import schema as sch
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.kv_cache import CachePool
    from repro_torch.testing import LLM_RTOL, rel_err
    full = get_config(LLM_ARCH)
    cfg = dataclasses.replace(full, name=LLM_ARCH + "-9-layers",
                              num_layers=9, num_blocks=1)
    params = {"cuda": tfm.init_params(cfg, SEED, "cuda")}
    params["cpu"] = sch.tree_map(lambda t: t.cpu(), params["cuda"])
    reqs = llm_requests(np, cfg, 4, 40, 1, seed=1)
    worst, ties, compared = 0.0, 0, 0

    def check(what, got, want):
        nonlocal worst, ties, compared
        got, want = got.cpu().numpy(), want.numpy()
        if not np.isfinite(got).all():
            raise AssertionError(f"{what}: non-finite logits on the card")
        err = rel_err(got, want)
        worst = max(worst, err)
        if err > LLM_RTOL:
            raise AssertionError(f"{what}: card vs CPU logits differ by "
                                 f"{err:.2e} of their scale (> {LLM_RTOL})")
        scale = max(1.0, float(np.abs(want).max()))
        top2 = np.sort(want, -1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) < LLM_RTOL * scale
        same = got.argmax(-1) == want.argmax(-1)
        if (~same & ~near).any():
            raise AssertionError(f"{what}: greedy token differs away from a "
                                 "top-2 tie")
        ties += int(near.sum())
        compared += same.size

    pools = {d: CachePool(cfg, 4, 64, d) for d in ("cuda", "cpu")}
    nxt = np.zeros((4, 1), np.int64)
    for slot, req in enumerate(reqs):
        out = {}
        for d in ("cuda", "cpu"):
            toks = torch.as_tensor(req.prompt, device=d)[None]
            logits, one = tfm.prefill(cfg, params[d], toks,
                                      tfm.init_cache(cfg, 1, 64, d))
            pools[d].write_prefill(slot, one, len(req.prompt))
            out[d] = logits
        check(f"prefill {slot}", out["cuda"], out["cpu"])
        nxt[slot, 0] = int(out["cuda"][0].argmax())
    lens = np.asarray([len(r.prompt) for r in reqs])
    for step in range(6):
        out = {}
        for d in ("cuda", "cpu"):
            out[d], pools[d].cache = tfm.decode_step(
                cfg, params[d], torch.as_tensor(nxt, device=d),
                pools[d].cache, torch.as_tensor(lens + step, device=d))
        check(f"decode step {step}", out["cuda"][:, 0], out["cpu"][:, 0])
        nxt[:, 0] = out["cuda"][:, 0].argmax(-1).cpu().numpy()
    print(f"LLM card vs CPU reference, {cfg.name} at full width "
          f"({sch.param_bytes(tfm.model_schema(cfg)) / 4e9:.3f} B "
          f"parameters): 4 prefills + 6 decode steps, logits within "
          f"{worst:.2e} of their scale (tolerance {LLM_RTOL}), greedy tokens "
          f"equal at {compared - ties} of {compared} positions ({ties} "
          f"top-2 tie(s) exempt) [{card}]")
    del params, pools
    torch.cuda.empty_cache()


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout (e.g. the parent commit from git "
                         "archive): its K2 and K5 phases run before and "
                         "after this tree's, on the same card")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit("chip_smoke.py: src/repro_torch not found next to "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, SRC)
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

    before = parent_device_ms(args.parent, card) if args.parent else None
    crop_row = phase_crop_gather(torch, np, card)
    update_rows = phase_onevsall_update(torch, np, card)
    after = parent_device_ms(args.parent, card) if args.parent else None
    for tag, row in [("K2", crop_row)] + [("K5", r) for r in update_rows]:
        key = (tag, row["shape"].split()[0])
        row["parent_device_ms"] = (None if before is None
                                   else [before.get(key), after.get(key)])
        print(f"{tag} {row['shape']}: parent's device time "
              + ("not measured (no --parent)" if before is None else
                 f"{before.get(key)} ms before, {after.get(key)} ms after "
                 f"this tree's, this tree {fmt(row['device_ms'])}")
              + f" [{card}]")
    update_row = phase_onevsall_replay(torch, np, card)
    update_row["update_shapes"] = update_rows
    video_rows = [phase_region_filter(torch, np, card), crop_row,
                  phase_onevsall(torch, np, card)]
    iou_row = phase_iou_matrix(torch, np, card)
    frame_row = phase_frame_filter(torch, np, card)
    llm_rows = [phase_flash_attention(torch, np, card),
                phase_decode_attention(torch, np, card),
                phase_ssd_scan(torch, np, card)]
    phase_nms(torch, np, card)
    phase_reference(torch, np, card)
    fused_counts, sync_counts, _ = phase_main_path(torch, np, card)
    for row in video_rows + [iou_row]:
        row["launches"] = fused_counts[row["name"]]
        row["launches_sync"] = sync_counts[row["name"]]
    phase_baselines_reference(torch, np, card)
    base_counts = phase_baselines_main_path(torch, np, card)
    iou_row["launches_baselines"] = {
        name: c["iou_matrix"] for name, c in base_counts.items()}
    frame_row["launches"] = base_counts["dds"]["region_filter_mask"]
    phase_learning_reference(torch, np, card)
    learn_counts = phase_learning_main_path(torch, np, card)
    update_row.update(launches=learn_counts["onevsall_update"],
                      launches_replay=learn_counts["onevsall_replay"],
                      steps=learn_counts["onevsall_steps"],
                      launches_inline=learn_counts["inline_launches"],
                      steps_inline=learn_counts["inline_steps"])
    iou_row["launches_learning"] = learn_counts["iou_matrix"]
    phase_llm_reference(torch, np, card)
    llm_counts = phase_llm_main_path(torch, np, card)
    for row in llm_rows:
        row["launches"] = llm_counts[row["name"]]
    rows = video_rows + [iou_row, frame_row, update_row] + llm_rows
    print(f"chip_smoke.py finished its checks in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
