"""Serving launcher: LLM continuous batching or the video function graph,
on the card.

LLM mode (continuous-batching server over ``--arch <id>``, random weights
from a ``torch.Generator`` on the device, seed 0):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --requests 8 --slots 4 --max-seq 512 --prompt-len 384
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b-smoke --device cpu      # MoE + MLA

A config with frontend context (musicgen, llama-vision) is refused, as in
the reference: the server takes no frontend embeddings.  Drive it through
``transformer.prefill`` / ``decode_step`` with ``ctx_embed``.

Video mode (N camera streams through the function graph with cross-stream
batched cloud inference + autoscaling):

  PYTHONPATH=src python -m repro_torch.launch.serve --video-streams 8 \\
      --video-chunks 4

SLO-aware serving plane (per-stream latency SLOs with deadline-driven
batching, detector replica sharding, weighted-fair stream priorities):

  PYTHONPATH=src python -m repro_torch.launch.serve --video-streams 8 \\
      --video-replicas 2 --video-slo 0.4 --video-weights 4,1

Continual-learning plane (drift is injected into the second half of each
stream; the plane detects it, labels under --label-budget, trains in the
background -- each proximal step one launch of the fused update kernel --
and hot-swaps promoted fog models mid-run):

  PYTHONPATH=src python -m repro_torch.launch.serve --video-streams 4 \\
      --video-chunks 6 --learning --label-budget 256 --drift-window 8

PyTorch port of ``repro.launch.serve``.  ``--device`` defaults to ``cuda``;
float32 means float32 there (TF32 off, see
:func:`repro_torch.set_reference_precision`).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import require_device, set_reference_precision


def serve_llm(args) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.server import LLMServer, Request

    cfg = get_config(args.arch)
    if cfg.num_ctx_tokens:
        raise SystemExit(f"{cfg.name} needs frontend embeddings, which "
                         "LLMServer does not take; call transformer.prefill "
                         "/ decode_step with ctx_embed instead")
    device = require_device(args.device)
    set_reference_precision()
    params = tfm.init_params(cfg, 0, device)
    server = LLMServer(cfg, params, num_slots=args.slots,
                       max_seq=args.max_seq, eos_token=-1)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        server.submit(Request(i, rng.integers(0, cfg.vocab_size,
                                              args.prompt_len),
                              max_new_tokens=args.max_new))
    t0 = time.time()
    finished = server.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    tokens = sum(len(r.output) for r in finished)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"{cfg.name}: served {len(finished)} requests, {tokens} tokens "
          f"in {dt:.1f}s ({tokens / dt:.1f} tok/s on {where})")
    for r in finished[:3]:
        print(f"  req {r.request_id}: {len(r.output)} tokens, "
              f"min-confidence {r.confidence:.3f}")


def drifted_streams(args):
    """The continual-learning demo's workload: the second half of each
    stream drifts -- with per-site learning only camera 0 drifts, so the
    demo shows a single-site episode leaving every other camera's readout
    alone."""
    from repro_torch.video import synthetic

    def _chunk(rng, i, j):
        drifts = (i == 0) if args.per_site_learning else True
        drift = 1.0 if drifts and j >= args.video_chunks // 2 else 0.0
        return synthetic.drifted_chunk(rng, "traffic", drift=drift,
                                       num_frames=args.video_frames)
    return [[_chunk(np.random.default_rng(50 + i + 97 * j), i, j)
             for j in range(args.video_chunks)]
            for i in range(args.video_streams)]


def learning_config(args):
    """The ``LearningConfig`` of ``--learning``: warmup and the EWMA span
    must fit inside the per-stream chunk count, and short demos can't
    afford multi-observation patience."""
    from repro_torch.learning import DriftConfig, LearningConfig
    pre = max(1, args.video_chunks // 2)
    return LearningConfig(
        label_budget=args.label_budget, sentinel_per_chunk=2,
        labels_per_round=16, min_batch=8, min_holdout=4,
        per_site=args.per_site_learning,
        ensemble_serving=args.ensemble_serving,
        sentinel_mode=("active" if args.per_site_learning else "uniform"),
        drift=DriftConfig(window=min(args.drift_window, max(2, pre)),
                          warmup=max(2, pre // 2), patience=1,
                          threshold=0.4, cooldown=4))


def serve_video(args) -> None:
    """Video function-graph serving demo: synthetic cameras, random-init
    models (throughput/scheduling demo — accuracy needs trained weights)."""
    from repro_torch import weights
    from repro_torch.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro_torch.core.coordinator import (MultiStreamCoordinator,
                                              StreamSpec)
    from repro_torch.core.protocol import HighLowProtocol
    from repro_torch.serving.autoscaler import Autoscaler
    from repro_torch.video import synthetic

    device = require_device(args.device)
    set_reference_precision()
    det_params = weights.init_detector(
        DETECTOR, torch.Generator().manual_seed(0), device)
    clf_params = weights.init_classifier(
        CLASSIFIER, torch.Generator().manual_seed(1), device)
    if args.learning:
        # drift detection watches oracle-verified accuracy, so it needs a
        # *trained* classifier; use the trained models under artifacts/
        from repro_torch.training.train_loop import ARTIFACTS
        det_path = os.path.join(ARTIFACTS, "det_params.npz")
        clf_path = os.path.join(ARTIFACTS, "clf_params.npz")
        if os.path.exists(det_path) and os.path.exists(clf_path):
            det_params = weights.load_npz(det_path, device)
            clf_params = weights.load_npz(clf_path, device)
        else:
            print("note: no trained artifacts/ found — with random-init "
                  "weights the drift statistic carries no signal, so the "
                  "plane will stay in monitor state (train them into "
                  "artifacts/ with repro_torch.training.train_loop"
                  ".load_or_train(), e.g. PYTHONPATH=src python -c 'from "
                  "repro_torch.training.train_loop import load_or_train; "
                  "load_or_train()')")
        streams = drifted_streams(args)
    else:
        streams = [[synthetic.make_chunk(np.random.default_rng(50 + i),
                                         "traffic",
                                         num_frames=args.video_frames)
                    for _ in range(args.video_chunks)]
                   for i in range(args.video_streams)]

    weights_wfq = [1.0] * args.video_streams
    if args.video_weights:
        given = [float(w) for w in args.video_weights.split(",")]
        weights_wfq = (given + weights_wfq)[: args.video_streams]
    specs = [StreamSpec(name=f"cam{i}", chunks=chunks,
                        slo=args.video_slo or None, weight=weights_wfq[i])
             for i, chunks in enumerate(streams)]

    scaler = Autoscaler(min_devices=1, max_devices=8, cooldown_s=0.5,
                        unit="replicas" if args.video_replicas > 1
                        else "devices")
    plane = None
    if args.learning:
        from repro_torch.learning import ContinualLearningPlane
        plane = ContinualLearningPlane(CLASSIFIER.num_classes,
                                       learning_config(args))
    multi = MultiStreamCoordinator(
        HighLowProtocol(DETECTOR, CLASSIFIER, device=device), det_params,
        clf_params, specs, max_batch_chunks=args.video_streams,
        batch_window=args.video_window,
        cloud_replicas=args.video_replicas, autoscaler=scaler,
        cold_start_s=args.video_cold_start,
        hot_path=args.video_hot_path, learning_plane=plane, device=device)
    t0 = time.time()
    out = multi.run(learn=args.learning)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    rep = multi.report()
    total_chunks = sum(len(s) for s in streams)
    makespan = max(st.clock for st in multi.scheduler.streams.values())
    print(f"video graph: {args.video_streams} streams, {total_chunks} "
          f"chunks in {dt:.1f}s wall ({makespan:.1f}s simulated)")
    print(f"  detect stage: {rep['calls']} batched calls, "
          f"{rep['frames']} frames (+{rep['padded_frames']} pad), "
          f"{rep['frames_per_s']:.0f} frames/s wall, "
          f"{rep.get('sim_frames_per_s', 0):.0f} frames/s simulated "
          f"across {rep['replicas']} replica(s)")
    print(f"  batching: up to {rep['batch_max_batch_chunks']} chunks/call "
          f"({rep['batch_deadline_flushes']:.0f} deadline-driven); "
          f"autoscaler {scaler.summary()}")
    print(f"  hot path: {rep['hot_path']} — "
          f"{rep.get('host_syncs_per_flush', 0):.1f} host syncs/flush, "
          f"classify FLOPs saved {rep.get('classify_flops_saved_frac', 0):.0%}, "
          f"in-flight result peak {rep.get('hot_inflight_peak', 0)}")
    if args.video_slo:
        mon = multi.scheduler.monitor
        print(f"  SLO {args.video_slo*1e3:.0f} ms: attainment "
              f"{rep.get('slo_attainment', 0.0):.2f}, p99 latency "
              f"{mon.percentile('latency', 99)*1e3:.0f} ms")
    if plane is not None:
        print_learning_summary(plane.summary())
    for name, r in list(out.items())[:3]:
        print(f"  {name}: wan {r.bandwidth/1e3:.1f} kB, cost "
              f"{r.cloud_cost:.0f}, mean latency "
              f"{np.mean(r.latencies)*1e3:.0f} ms")


def print_learning_summary(s) -> None:
    print(f"  learning plane [{s['state']}]: {s['drift_events']} drift "
          f"event(s), {s['labels_charged']}/{s['label_budget']} labels, "
          f"{s['trainer'].get('rounds', 0)} train round(s), "
          f"{s['promotions']} promotion(s), {s['rollbacks']} "
          f"rollback(s), {s['hot_swaps']} hot-swap(s)"
          + ("" if s["per_site"] else
             f", live model v{s['live_version']}"))
    if s["per_site"]:
        for name, site in sorted(s.get("sites", {}).items()):
            print(f"    site {name} [{site['state']}]: "
                  f"{site['episodes']} episode(s), "
                  f"{site['promotions']} promotion(s), "
                  f"{site['ensemble_promotions']} ensemble "
                  f"promotion(s), live v{site['live_version']}, "
                  f"{s['sentinel_by_stream'].get(name, 0)} sentinel "
                  f"label(s)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' runs the hand-written kernels, "
                         "'cpu' their plain PyTorch versions")
    ap.add_argument("--arch", default=None,
                    help="LLM arch id (LLM serving mode)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--video-streams", type=int, default=0,
                    help="serve N synthetic camera streams through the "
                         "video function graph instead of an LLM")
    ap.add_argument("--video-chunks", type=int, default=4)
    ap.add_argument("--video-frames", type=int, default=4)
    ap.add_argument("--video-replicas", type=int, default=1,
                    help="cloud detector replicas (batches are sharded "
                         "across them; autoscaler then scales replicas)")
    ap.add_argument("--video-slo", type=float, default=0.0,
                    help="per-chunk end-to-end latency SLO in seconds "
                         "(0 = best-effort fixed-window batching)")
    ap.add_argument("--video-weights", default="",
                    help="comma-separated per-stream fair-queueing weights "
                         "(e.g. 4,1,1 — cam0 gets 4x detector service)")
    ap.add_argument("--video-window", type=float, default=0.05,
                    help="fixed batching window for streams without an SLO")
    ap.add_argument("--video-cold-start", type=float, default=0.0,
                    help="serverless container spin-up seconds for replicas "
                         "added by the autoscaler")
    ap.add_argument("--video-hot-path", default="fused",
                    choices=("fused", "sync"),
                    help="'fused' = device-resident hot path (one fused "
                         "detect+split dispatch and one host sync per "
                         "flush, compacted cross-stream classify); 'sync' "
                         "= the pre-fusion baseline for A/B comparison")
    ap.add_argument("--learning", action="store_true",
                    help="attach the continual-learning plane (drift "
                         "detection, budgeted labeling, background "
                         "training, fog-model hot-swap) and inject drift "
                         "into the second half of each stream")
    ap.add_argument("--per-site-learning", action="store_true",
                    help="per-camera learning lineages: a drift episode in "
                         "one stream trains, shadow-evaluates, and "
                         "hot-swaps only that stream's readout (drift is "
                         "then injected into camera 0 only); sentinel "
                         "spot-checks are actively scheduled by per-stream "
                         "health uncertainty")
    ap.add_argument("--ensemble-serving", action="store_true",
                    help="at episode close, serve the Eq. 9 snapshot "
                         "ensemble (fog.classify_ensemble) when it beats "
                         "the latest promoted readout on the holdout")
    ap.add_argument("--label-budget", type=int, default=256,
                    help="human labor budget tau for the learning plane")
    ap.add_argument("--drift-window", type=int, default=8,
                    help="EWMA span (observations) of the drift detector")
    args = ap.parse_args()
    if args.per_site_learning or args.ensemble_serving:
        # both flags configure the learning plane; without it they would
        # silently do nothing
        args.learning = True
    if args.video_streams > 0:
        serve_video(args)
    elif args.arch:
        serve_llm(args)
    else:
        raise SystemExit("pass --arch <id> (LLM) or --video-streams N")


if __name__ == "__main__":
    main()
