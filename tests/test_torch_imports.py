"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
``torch``, never ``jax`` and nothing of the JAX package ``repro``."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["repro"] = None        # ... and so does the JAX package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                  # imported, not run
assert callable(chip_smoke.main)
from repro_torch.baselines import (BaselineResult, CloudSegBaseline,
                                   DDSBaseline, GlimpseBaseline, MPEGBaseline)
from repro_torch.serving.policies import (default_policies,
                                          default_tenant_pipelines)
assert default_policies().list() == ["cloudseg", "dds", "glimpse", "mpeg",
                                     "vpaas-highlow"]
assert default_tenant_pipelines().list() == ["detection", "llm-cascade",
                                             "retail-content"]
from repro_torch.core.cascade import BigLittleCascade
from repro_torch.serving.shards import ShardedScheduler
from repro_torch.serving.tenancy import content_pipeline, llm_cascade_pipeline
from repro_torch.models.attention import (cross_attention, mla_attention,
                                          mla_cache_spec)
from repro_torch.models.layers import softcap
from repro_torch.models.moe import moe_apply
from repro_torch.models.stubs import frontend_embeddings
from repro_torch.models.transformer import loss_fn
from repro_torch.training.train_loop import (llm_grads, make_train_step,
                                             train_llm)
from repro_torch.launch.specs import arch_for_shape, make_step
from repro_torch.launch.train import main as train_main
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_vjp)
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan_vjp
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.profile import kv_cache_bytes, profile_arch
from repro_torch.launch.specs import input_specs
from repro_torch.models.sharding import PartitionSpec, default_rules
from repro_torch.models.stubs import frontend_spec
from repro_torch.models.transformer import (abstract_cache, abstract_params,
                                            block_unit_specs,
                                            cache_partition_specs,
                                            param_partition_specs)
from repro_torch.roofline.analysis import (RooflineReport, analyze_step,
                                           collective_bytes, model_flops)
from repro_torch.roofline.hw import H100
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               or m == "repro" for m in sys.modules
               if sys.modules[m] is not None)
print(" ".join(names))
print(len(names))
"""

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                        re.MULTILINE)


def test_port_imports_with_jax_blocked():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 80      # every module imported
    names = proc.stdout.split()
    for mod in ("baselines.common", "baselines.mpeg", "baselines.glimpse",
                "baselines.cloudseg", "baselines.dds", "serving.policies",
                "kernels.iou_matrix", "kernels.region_filter_mask",
                "training.checkpoint", "training.data",
                "training.optimizer", "training.train_loop",
                "serving.shards", "core.cascade", "models.moe",
                "models.stubs", "models.attention", "models.transformer",
                "launch.specs", "launch.train", "launch.dryrun",
                "launch.mesh", "launch.profile", "models.sharding",
                "roofline.analysis", "roofline.hw"):
        assert f"repro_torch.{mod}" in names, mod


def test_no_jax_or_reference_imports_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = {str(f.relative_to(ROOT)): m.group(0).strip()
                 for f in files
                 for m in _FORBIDDEN.finditer(f.read_text())}
    assert not offenders, offenders
