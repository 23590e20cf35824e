"""Dry run on one H100: the roofline of every (arch x input shape), then the
step itself on the card at the largest batch that fits (port of
``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-7b \\
      --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device meta

The reference lowers and compiles each step for a 256-chip TPU pod and
reads XLA's cost and memory analyses.  Here :func:`run_one` makes two
passes:

* **Abstract** (always): the step of ``launch.specs.make_step`` runs on
  meta tensors at the full ``INPUT_SHAPES`` shape
  (``roofline.analysis.analyze_step``): FLOPs, bytes, the roofline terms on
  ``H100``, argument, output and peak live bytes, whether the peak fits the
  card's HBM, and the largest global batch that fits (only the batch is
  cut; the sequence is kept).  That batch comes from the peaks at the full
  batch and at batch 1 (the peak is affine in the batch), confirmed by a
  pass at it.
* **On the card** (``device="cuda"``, where a batch >= 1 fits;
  :func:`card_pass`): seeded random parameters, cache and context in
  ``launch.specs.COMPUTE_DTYPE`` (bfloat16, as the abstract pass counts
  them), the step run once
  at ``WARMUP_SEQ`` tokens to warm up, then timed (CUDA events) at that
  batch, a decode step ``DECODE_CALLS`` times: its median time and
  spread, the card's peak allocated memory, the K6 / K7 / K8 launches of
  one call, and the roofline floor at that cut shape beside the time.
  This is the one-card counterpart of the reference's compile plus
  ``memory_analysis``.

``--multi-pod`` raises, as ``launch.mesh.make_production_mesh`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
import traceback

import torch

from repro_torch import require_device, set_reference_precision
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import INDEX_DTYPE, arch_for_shape, make_step
from repro_torch.models import stubs
from repro_torch.models import transformer as tfm
from repro_torch.roofline.analysis import RooflineReport, analyze_step
from repro_torch.roofline.hw import H100
from repro_torch.training.optimizer import AdamW

ARTIFACT_DIR = os.environ.get(
    "REPRO_DRYRUN_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..",
                 "artifacts", "dryrun"))

# the kernels of the LLM steps, by launch-count name, and their bf16
# launches
STEP_KERNELS = ("flash_attention", "decode_attention", "ssd_scan",
                "flash_attention_bf16", "decode_attention_bf16",
                "ssd_scan_bf16")
# the plain VJPs a train step runs backward of K6's and K8's launches
STEP_VJPS = ("flash_attention_vjp", "ssd_scan_vjp")
# the warm-up call's sequence (cache) length: it loads the kernels and
# cuBLAS's handles at a fraction of a 32k step's time
WARMUP_SEQ = 256
# the seed of the card pass's random parameters and tokens
SEED = 0
# timed calls of a decode step (its time is the median: one call of a
# host-bound step varies by half between runs)
DECODE_CALLS = 15


def abstract_pass(cfg, shape, arch: str) -> RooflineReport:
    """The step at ``shape`` counted on meta tensors (no microbatches: a
    step's FLOPs and bytes do not depend on them)."""
    fn, args, _, _ = make_step(cfg, shape, microbatch=1)
    return analyze_step(fn, args, arch=arch, shape=shape, cfg=cfg)


def fit_batch(cfg, shape, arch: str, full: RooflineReport):
    """(largest global batch <= shape's whose peak fits the card's HBM, or
    0; the report at that batch, or None; the report at batch 1, or None
    where the full batch fits).  The batch is extrapolated from the peaks
    at batch 1 and the full batch and confirmed by a pass at it (down
    while it does not fit).  A train step's peak is not affine in the
    batch: at small batches the AdamW update's, the same at any batch,
    lies above the backward's, so the extrapolation from batch 1 falls
    short; while the found batch's own peak leaves a row's extrapolated
    slope under the HBM, the next batch is tried (up while it fits)."""
    hbm, big = H100.hbm_bytes, shape.global_batch
    if full.peak_memory_per_device <= hbm:
        return big, full, None
    one = full if big == 1 else abstract_pass(
        cfg, dataclasses.replace(shape, global_batch=1), arch)
    if one.peak_memory_per_device > hbm:
        return 0, None, one
    slope = (full.peak_memory_per_device - one.peak_memory_per_device) \
        / (big - 1)

    def at(b):
        return abstract_pass(cfg, dataclasses.replace(shape, global_batch=b),
                             arch)
    b = min(big - 1, 1 + int((hbm - one.peak_memory_per_device) // slope))
    rep = one
    while b > 1:
        rep = at(b)
        if rep.peak_memory_per_device <= hbm:
            break
        b -= 1
    else:
        b, rep = 1, one
    while b < big - 1 and rep.peak_memory_per_device + slope <= hbm:
        nxt = at(b + 1)
        if nxt.peak_memory_per_device > hbm:
            break
        b, rep = b + 1, nxt
    return b, rep, one


def step_inputs(cfg, shape, device, params=None, opt_state=None) -> list:
    """Real arguments of ``make_step``'s step on ``device``: ``params`` or
    parameters in ``launch.specs.COMPUTE_DTYPE`` and tokens drawn from
    ``SEED``, stub context in that dtype; for train ``opt_state`` or a
    fresh AdamW state, and labels; for decode a zeroed cache in that dtype
    whose last slot is the one written (the step attends over all of
    it)."""
    dtype = specs.COMPUTE_DTYPE
    if params is None:
        params = tfm.init_params(cfg, SEED, device, dtype)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    b, s = shape.global_batch, shape.seq_len

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             device=device, dtype=INDEX_DTYPE)
    ctx = (stubs.frontend_embeddings(cfg, b, generator=gen, device=device,
                                     dtype=dtype)
           if cfg.num_ctx_tokens else None)
    if shape.mode == "train":
        batch = {"tokens": tokens(s), "labels": tokens(s)}
        if ctx is not None:
            batch["ctx_embed"] = ctx
        return [params, AdamW().init(params) if opt_state is None
                else opt_state, batch]
    real = [params, tokens(s if shape.mode == "prefill" else 1)]
    if shape.mode == "decode":
        real += [tfm.init_cache(cfg, b, s, device, dtype),
                 torch.tensor(s - 1, dtype=INDEX_DTYPE, device=device)]
    return real + ([ctx] if ctx is not None else [])


def card_pass(cfg, shape, dry: dict) -> dict:
    """The step on the card at the batch the abstract pass ``dry`` picked
    (``run_one(device="meta")``'s dict): once at ``WARMUP_SEQ`` tokens to
    warm up, then timed with CUDA events at that batch, each call from an
    idle card (``DECODE_CALLS`` calls of a decode step, which is cheap and
    host-bound; one call of the others).  Reports the median ms and the
    fastest and slowest calls; the peak allocated bytes (above what was
    allocated before the step's arguments were made: the prediction counts
    the arguments and what the step adds); the launch counts of the first
    timed call (a train step's plain VJPs too); whether its logits (train:
    the loss) are finite; and beside them the prediction: the peak and the
    floor at that batch.  A train step warms up on the timed call's AdamW
    state (the step makes a new one and leaves it as it was): a second
    state beside it would pass the card's HBM."""
    device = require_device("cuda")
    set_reference_precision()
    b = dry["max_batch"]
    shape = dataclasses.replace(shape, global_batch=b)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    real = step_inputs(cfg, shape, device)
    warm = dataclasses.replace(shape, seq_len=min(shape.seq_len, WARMUP_SEQ))
    make_step(cfg, warm)[0](*step_inputs(
        cfg, warm, device, real[0],
        real[1] if shape.mode == "train" else None))
    fn = make_step(cfg, shape)[0]
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    times, counts, finite = [], None, True
    for _ in range(DECODE_CALLS if shape.mode == "decode" else 1):
        ops.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*real)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if counts is None:
            counts = {**ops.launch_counts(), **ops.bf16_launch_counts(),
                      **ops.d64_launch_counts()}
        head = out[2]["loss"] if shape.mode == "train" else out[0]
        finite = finite and bool(torch.isfinite(head).all())
    floor_ms = dry["cut_t_floor"] * 1e3
    ms = statistics.median(times)
    result = {"batch": b, "ms": ms, "ms_min": min(times),
              "ms_max": max(times), "calls": len(times),
              "peak_bytes": torch.cuda.max_memory_allocated(device) - base,
              "launches": {k: counts[k] for k in STEP_KERNELS + STEP_VJPS},
              "launches_d64": counts["flash_attention_bf16_d64"],
              "out_shape": list(head.shape), "finite": finite,
              "predicted_peak_bytes": dry["cut_peak_bytes"],
              "floor_ms": floor_ms, "dominant": dry["cut_dominant"],
              "over_floor": ms / floor_ms,
              "device": torch.cuda.get_device_name(device)}
    del real, out, head
    torch.cuda.empty_cache()
    return result


def run_one(arch: str, shape_name: str, *, device: str = "cuda",
            multi_pod: bool = False, verbose: bool = True,
            save: bool = True) -> dict:
    """The abstract pass, and on ``device="cuda"`` the card pass (module
    docstring).  Returns the report's dict with ``fits``, ``max_batch``,
    ``batch1_peak_bytes`` (None where the full batch fits),
    ``t_abstract_s``, the peak, floor and dominant term at ``max_batch``
    (``cut_peak_bytes``, ``cut_t_floor``, ``cut_dominant``; None where no
    batch fits) and, after a card pass, ``card``: the measured ``ms``
    beside the cut batch's floor (``floor_ms``)."""
    if multi_pod:
        make_production_mesh(multi_pod=True)
    if device not in ("cuda", "meta"):
        raise ValueError(f"dryrun: device {device!r} (cuda or meta)")
    shape = INPUT_SHAPES[shape_name]
    cfg = arch_for_shape(get_config(arch), shape)

    t0 = time.time()
    report = abstract_pass(cfg, shape, arch)
    max_batch, cut, one = fit_batch(cfg, shape, arch, report)
    result = report.to_dict()
    result.update(
        ok=True, cfg=cfg.name, t_abstract_s=time.time() - t0,
        fits=report.peak_memory_per_device <= H100.hbm_bytes,
        max_batch=max_batch, hbm_bytes=H100.hbm_bytes,
        batch1_peak_bytes=None if one is None
        else one.peak_memory_per_device,
        cut_peak_bytes=cut and cut.peak_memory_per_device,
        cut_t_floor=cut and cut.t_floor, cut_dominant=cut and cut.dominant)

    if device == "cuda" and max_batch:
        result["card"] = card_pass(cfg, shape, result)

    if verbose:
        print(f"== {arch} x {shape_name} on one H100 "
              f"({report.compute_dtype}) ==")
        print(f"  abstract pass {result['t_abstract_s']:.1f}s: "
              f"flops={report.hlo_flops:.3e} bytes={report.hlo_bytes:.3e} "
              f"args={report.arg_bytes / 1e9:.2f}GB "
              f"peak={report.peak_memory_per_device / 1e9:.2f}GB "
              f"fits={result['fits']} max_batch={max_batch}")
        print(f"  roofline: compute={report.t_compute * 1e3:.2f}ms "
              f"memory={report.t_memory * 1e3:.2f}ms "
              f"-> dominant={report.dominant} "
              f"useful={report.useful_flops_ratio:.2f}")
        if "card" in result:
            c = result["card"]
            print(f"  card ({c['device']}, batch {c['batch']}): "
                  f"{c['ms']:.2f} ms (median of {c['calls']}, "
                  f"{c['ms_min']:.2f}-{c['ms_max']:.2f}) against a floor "
                  f"of {c['floor_ms']:.2f} ms ({c['over_floor']:.2f}x); "
                  f"peak {c['peak_bytes'] / 1e9:.2f} GB against "
                  f"{c['predicted_peak_bytes'] / 1e9:.2f} GB predicted; "
                  f"launches {c['launches']}")
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        with open(os.path.join(ARTIFACT_DIR,
                               f"{arch}_{shape_name}_h100.json"), "w") as f:
            json.dump(result, f, indent=2, default=str)
    return result


def main(argv=None) -> None:
    # the card pass fills the card to within a few GB of the abstract
    # pass's peak: expandable segments keep the caching allocator's
    # fragmentation from running it out of memory (set before the first
    # CUDA allocation, which reads it)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None,
                    choices=sorted(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) combination")
    ap.add_argument("--device", choices=["cuda", "meta"], default="cuda",
                    help="meta: the abstract pass only")
    args = ap.parse_args(argv)
    if args.multi_pod:
        make_production_mesh(multi_pod=True)

    if args.all:
        archs, shapes = list_archs(), sorted(INPUT_SHAPES)
    else:
        archs = [args.arch or "zamba2-7b"]
        shapes = [args.shape or "prefill_32k"]

    failures = []
    for arch in archs:
        for shape in shapes:
            try:
                run_one(arch, shape, device=args.device)
            except Exception as e:   # noqa: BLE001 -- report every combo
                failures.append((arch, shape, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall {len(archs) * len(shapes)} combos ran on one H100 "
          f"({args.device})")


if __name__ == "__main__":
    main()
