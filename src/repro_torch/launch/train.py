"""Training launcher: ``--arch <id>`` on one card, port of
``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b-smoke \\
      --steps 100 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b-smoke \\
      --device cpu --steps 5

The step is ``launch.specs.make_step`` (remat on, ``--microbatch`` for
gradient accumulation); batches come from ``TokenStream`` and, for a
config with frontend context, stub embeddings seeded with the step.
``--device`` defaults to ``cuda``.  Gaps against the reference: only
``--mesh host`` (one card) runs -- ``pod`` and ``multipod`` raise through
``launch.mesh.make_production_mesh``, as they need a TPU pod of 256 or 512
chips.  As in the reference, the parameters are bfloat16 (the AdamW
moments float32) and the step computes in ``launch.specs.COMPUTE_DTYPE``
(bfloat16): K6 and K8 run on bf16 operands.  ``--save`` writes the bf16
parameters as float32 (exactly), which both packages' ``restore`` read
back into a bf16 tree.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import require_device, set_reference_precision
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.specs import make_step
from repro_torch.models import stubs
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint
from repro_torch.training.data import TokenStream
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_loop import to_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default="host")
    ap.add_argument("--save", default=None, help="checkpoint path")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    mesh = (make_host_mesh() if args.mesh == "host"
            else make_production_mesh(multi_pod=args.mesh == "multipod"))

    device = require_device(args.device)
    set_reference_precision()
    cfg = get_config(args.arch)
    shape = ShapeConfig("custom", args.seq, args.batch, "train")
    step_fn = make_step(cfg, shape, mesh=mesh, lr=args.lr,
                        microbatch=args.microbatch)[0]

    params = tfm.init_params(cfg, 0, device, torch.bfloat16)
    opt_state = AdamW(lr=args.lr).init(params)
    stream = iter(TokenStream(cfg.vocab_size, args.seq, args.batch))

    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps, device={device}")
    t0 = time.time()
    for step in range(args.steps):
        batch = to_device(next(stream), device)
        if cfg.num_ctx_tokens:
            batch["ctx_embed"] = stubs.frontend_embeddings(
                cfg, args.batch,
                generator=torch.Generator(device=device).manual_seed(step),
                device=device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")
    if args.save:
        checkpoint.save(args.save, params, {"arch": args.arch,
                                            "steps": args.steps},
                        hwio=False)
        print(f"saved checkpoint to {args.save}")


if __name__ == "__main__":
    main()
