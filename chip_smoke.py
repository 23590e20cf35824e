#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the serving path's
shapes, times kernel, plain version and a library yardstick with CUDA
events, drives the full-width video serving path (``MultiStreamCoordinator``
with the ``vpaas_video`` models, random weights from a seed) on both hot
paths with the kernels' launch counts zeroed just before and read just
after, and checks its outputs against the port's CPU path on a small input.
Any failed check raises; nothing is caught.  The last three lines are the
card's name and power limit, one JSON object describing the kernels, and
``{"ok": true, "device": {...}}``.

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

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 outside the
# tensor cores -- the rates the bounds below divide by
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SEED = 0


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
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
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_device(torch, fn, reps: int = 1):
    """Run ``fn`` ``reps`` times under torch.profiler (CUPTI); return the
    device time per call in ms and the key averages (None when the
    profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    total_us = sum(_self_device_us(e) for e in avgs)
    return (total_us / reps / 1e3 if total_us > 0 else None), avgs


def measure(torch, fn, reps: int = 30):
    """(per-call time from CUDA events, device time per call from the
    profiler).  The first includes the host's launch path whenever the
    card waits for it; the second is the kernels' own execution time."""
    return time_ms(torch, fn, reps), profile_device(torch, fn, reps)[0]


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def phase_crop_gather(torch, np, card):
    import torch.nn.functional as F

    from repro_torch.kernels import crop_gather as cg
    from repro_torch.testing import rand_boxes
    f, n, hw, out_hw = 32, 256, (128, 128), (40, 40)
    rng = np.random.default_rng(SEED + 1)
    frames = torch.as_tensor(rng.random((f, *hw, 3), dtype=np.float32),
                             device="cuda")
    boxes = torch.as_tensor(rand_boxes(rng, (f, n)), device="cuda")
    main_row = None
    for b, n_valid in ((4, 2), (128, 100), (200, 200)):
        idxs = np.zeros((3, b), np.int32)
        idxs[0] = f                                 # out-of-bounds pad rows
        idxs[0, :n_valid] = rng.integers(0, f, n_valid)
        idxs[1, :n_valid] = rng.integers(0, n, n_valid)
        idx_t = torch.as_tensor(idxs, device="cuda")
        got = cg.crop_gather(frames, boxes, idx_t, out_hw=out_hw)
        want = cg.crop_gather_ref(frames, boxes, idx_t, out_hw=out_hw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K2 crops at B={b} differ from the plain version: max abs "
                f"{float((got - want).abs().max())}")
        timed = measure(torch, lambda: cg.crop_gather(frames, boxes, idx_t,
                                                      out_hw=out_hw))
        plain = measure(torch, lambda: cg.crop_gather_ref(
            frames, boxes, idx_t, out_hw=out_hw))
        # library yardstick: one grid_sample over the gathered frames, with
        # the gather and the sample grid built outside the timed call
        fi = idx_t[0].long().clamp(0, f - 1)
        bx = boxes[fi, idx_t[1].long().clamp(0, n - 1)]
        lin_y = torch.linspace(0, 1, out_hw[0], device="cuda")
        lin_x = torch.linspace(0, 1, out_hw[1], device="cuda")
        gy = (bx[:, 1:2] + (bx[:, 3:4] - bx[:, 1:2]) * lin_y) * 2 - 1
        gx = (bx[:, 0:1] + (bx[:, 2:3] - bx[:, 0:1]) * lin_x) * 2 - 1
        grid = torch.stack([gx[:, None, :].expand(b, *out_hw),
                            gy[:, :, None].expand(b, *out_hw)], -1)
        src = frames.permute(0, 3, 1, 2)[fi].contiguous()
        lib = time_ms(torch, lambda: F.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
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
                   lib, nbytes, ops)
        _report(f"K2 crop_gather B={b} ({n_valid} valid) F={f}: bit-equal",
                row, card, "grid_sample")
        if b == 128:                       # the path's largest bucket
            main_row = row
    return main_row


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
        timed = measure(torch, lambda: ov.onevsall_scores(x_t, ws_t, widx))
        plain = measure(torch, lambda: ov.onevsall_scores_ref(x_t, ws_t,
                                                              widx))
        lib = None
        if g == 1:
            w0 = ws_t[0]
            lib = time_ms(torch, lambda: torch.sigmoid(torch.mm(x_t, w0)))
        used = 1 if widx is None else int(widx.unique().numel())
        nbytes = ((b * d1 + used * d1 * c + b * c) * 4
                  + (b * 4 if g > 1 else 0))
        ops = b * c * (2 * d1 + 4)
        row = _row("onevsall_scores", "src/repro_torch/csrc/onevsall.cu",
                   "src/repro/kernels/onevsall.py:35",
                   f"B={b} G={g} D1={d1} C={c}", err, timed, plain, lib,
                   nbytes, ops)
        _report(f"K3 onevsall_scores B={b} G={g} D1={d1} C={c}: max abs err "
                f"{err:.3e}", row, card, "sigmoid(mm)" if g == 1 else None)
        if g == 1:                          # the full-budget classify batch
            main_row = row
    return main_row


def phase_nms(torch, np, card):
    """Plain greedy NMS (no kernel yet) at the fused flush's shape."""
    from repro_torch.kernels import ref
    from repro_torch.testing import rand_boxes
    f, n = 32, 256
    rng = np.random.default_rng(SEED + 3)
    boxes = torch.as_tensor(rand_boxes(rng, (f, n)), device="cuda")
    scores = torch.as_tensor(rng.random((f, n), dtype=np.float32),
                             device="cuda")
    valid = torch.as_tensor(rng.random((f, n)) > 0.5, device="cuda")
    ms = time_ms(torch, lambda: ref.nms_mask(boxes, scores, valid), reps=10,
                 warmup=2)
    dev, _ = profile_device(torch, lambda: ref.nms_mask(boxes, scores, valid))
    print(f"nms_mask (plain PyTorch, {n} greedy steps) F={f} N={n}: "
          f"{ms:.3f} ms per call ({fmt(dev)} on the device) [{card}]")


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


def phase_main_path(torch, np, card):
    from repro_torch import weights
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    n_streams, n_chunks, n_frames = 8, 4, 4
    params = (weights.init_detector(DETECTOR,
                                    torch.Generator().manual_seed(SEED),
                                    "cuda"),
              weights.init_classifier(CLASSIFIER,
                                      torch.Generator().manual_seed(SEED + 1),
                                      "cuda"))
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
    for name, cnt in fused_counts.items():
        if cnt == 0:
            raise AssertionError(f"fused path launched no {name} kernel")
    for name in ("region_filter_mask_batch", "onevsall_scores"):
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


def main() -> int:
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
    for line in _build.build_log.splitlines():
        if "registers" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    rows = [phase_region_filter(torch, np, card),
            phase_crop_gather(torch, np, card),
            phase_onevsall(torch, np, card)]
    phase_nms(torch, np, card)
    phase_reference(torch, np, card)
    fused_counts, sync_counts, _ = phase_main_path(torch, np, card)
    for row in rows:
        row["launches"] = fused_counts[row["name"]]
        row["launches_sync"] = sync_counts[row["name"]]
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
