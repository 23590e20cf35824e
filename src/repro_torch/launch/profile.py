"""Model profiler CLI (the global control plane's profiler, Fig. 3; port of
``repro.launch.profile``): analytic per-arch tables -- parameters,
per-shape model FLOPs, KV-cache and optimizer footprints, roofline-floor
step times on one H100.

  PYTHONPATH=src python -m repro_torch.launch.profile
  PYTHONPATH=src python -m repro_torch.launch.profile --arch zamba2-7b

The floors divide by the peak of the steps' compute dtype
(``launch.specs.COMPUTE_DTYPE``: bfloat16, ``H100.peak_flops_bf16``) and
by HBM bandwidth; the weights and the caches are of that dtype (2 bytes;
the SSM state 4), as the steps run them, and AdamW's moments float32.
``--chips`` (default 1) spreads the totals over that many cards, as the
reference spreads them over its pod.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import specs
from repro_torch.launch.specs import arch_for_shape
from repro_torch.roofline.analysis import DTYPE_NAME, model_flops
from repro_torch.roofline.hw import H100


def kv_cache_bytes(cfg, batch: int, seq: int, bytes_per: int = 2) -> int:
    """Decode-cache bytes of ``batch`` slots of ``seq`` positions: each
    attention layer's K and V (MLA: its latent and rope key), each SSM
    layer's float32 state and its conv window at ``bytes_per``."""
    total = 0
    kinds = (list(cfg.prefix_layers)
             + list(cfg.block_pattern) * cfg.num_blocks
             + list(cfg.suffix_layers))
    for k in kinds:
        if k in ("attn", "local", "moe", "cross", "shared_attn"):
            if cfg.mla:
                total += batch * seq * (cfg.kv_lora_rank
                                        + cfg.rope_head_dim) * bytes_per
            else:
                total += (2 * batch * seq * cfg.num_kv_heads * cfg.head_dim
                          * bytes_per)
        elif k in ("ssm", "ssm_ffn"):
            total += (batch * cfg.n_ssm_heads * cfg.ssm_head_dim
                      * cfg.ssm_state * 4
                      + batch * (cfg.conv_kernel - 1)
                      * (cfg.d_inner + 2 * cfg.ssm_state) * bytes_per)
    return total


def profile_arch(name: str, chips: int = 1) -> None:
    cfg = get_config(name)
    n = cfg.param_count()
    na = cfg.active_param_count()
    chip = H100
    dtype = specs.COMPUTE_DTYPE
    nbytes = dtype.itemsize
    label = DTYPE_NAME[dtype]
    print(f"\n== {name} [{cfg.family}] ==")
    print(f"  params {n / 1e9:.1f}B (active {na / 1e9:.1f}B), "
          f"{cfg.num_layers}L d{cfg.d_model} "
          f"{'MLA ' if cfg.mla else ''}"
          f"{'MoE ' + str(cfg.num_experts) + 'e ' if cfg.num_experts else ''}")
    print(f"  weights {label} {n * nbytes / 1e9:.1f} GB "
          f"({n * nbytes / chips / 1e9:.2f} GB/card @{chips}); "
          f"AdamW fp32 state {n * 8 / 1e9:.0f} GB "
          f"({n * 8 / chips / 1e9:.2f} GB/card)")
    for sname, shape in sorted(INPUT_SHAPES.items()):
        acfg = arch_for_shape(cfg, shape)
        mf = model_flops(acfg, shape)
        floor = mf / (chips * chip.peak_flops(label))
        kv = kv_cache_bytes(acfg, shape.global_batch, shape.seq_len, nbytes)
        line = (f"  {sname:12s} model_flops {mf:.2e}  "
                f"compute-floor {floor * 1e3:10.2f} ms/step")
        if shape.mode == "decode":
            line += (f"  cache {kv / 1e9:7.1f} GB "
                     f"({kv / chips / 1e9:.2f}/card, read-floor "
                     f"{kv / chips / chip.hbm_bandwidth * 1e3:.2f} ms)")
        print(line)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--chips", type=int, default=1)
    args = ap.parse_args(argv)
    for name in ([args.arch] if args.arch else list_archs()):
        profile_arch(name, args.chips)


if __name__ == "__main__":
    main()
