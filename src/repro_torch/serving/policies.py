"""Policy manager: registered scheduling policies selecting how a chunk is
served across the cloud-fog pair (§III.D policy manager + §IV coordinator);
PyTorch port of ``repro.serving.policies``.

The entry point of the baselines' path is
``default_policies().build(name, det_cfg, clf_cfg, device=...)``, then the
built system's ``process_chunk``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List


@dataclass
class Policy:
    name: str
    build: Callable[..., Any]        # (models, cfgs, **kw) -> serving system
    description: str = ""


class PolicyManager:
    def __init__(self):
        self._policies: Dict[str, Policy] = {}

    def register(self, name: str, build: Callable, description: str = ""):
        self._policies[name] = Policy(name, build, description)
        return self._policies[name]

    def build(self, name: str, *args, **kw):
        return self._policies[name].build(*args, **kw)

    def list(self) -> List[str]:
        return sorted(self._policies)

    def __contains__(self, name):
        return name in self._policies


def default_policies() -> PolicyManager:
    """The shipped policy set: VPaaS high-low + the comparison baselines."""
    from repro_torch.baselines import (CloudSegBaseline, DDSBaseline,
                                       GlimpseBaseline, MPEGBaseline)
    from repro_torch.core.protocol import HighLowProtocol

    pm = PolicyManager()
    pm.register("vpaas-highlow",
                lambda det_cfg, clf_cfg, **kw: HighLowProtocol(
                    det_cfg, clf_cfg, **kw),
                "client->fog->cloud high/low streaming (the paper)")
    pm.register("mpeg", lambda det_cfg, clf_cfg=None, **kw: MPEGBaseline(
        det_cfg, **kw), "original-quality cloud-only")
    pm.register("glimpse", lambda det_cfg, clf_cfg=None, **kw:
                GlimpseBaseline(det_cfg, **kw), "client-driven frame filter")
    pm.register("cloudseg", lambda det_cfg, clf_cfg=None, **kw:
                CloudSegBaseline(det_cfg, **kw), "low-res + SR recovery")
    pm.register("dds", lambda det_cfg, clf_cfg=None, **kw: DDSBaseline(
        det_cfg, **kw), "two-round server-driven streaming")
    return pm


def default_tenant_pipelines() -> PolicyManager:
    """The shipped multi-tenant pipeline catalog (tenancy.py): each entry
    builds a :class:`~repro_torch.serving.tenancy.TenantPipeline` a tenant
    can register on the shared serving substrate (``device=`` goes through
    to the constructor).  ``detection`` is the default High-Low graph
    (``pipeline=None`` in its TenantSpec)."""
    from repro_torch.serving.tenancy import (content_pipeline,
                                             llm_cascade_pipeline)

    pm = PolicyManager()
    pm.register("detection", lambda **kw: None,
                "High-Low detection analytics (the paper's pipeline)")
    pm.register("llm-cascade", lambda **kw: llm_cascade_pipeline(**kw),
                "big/little LLM cascade; cloud billed per escalated frame")
    pm.register("retail-content", lambda **kw: content_pipeline(**kw),
                "Hysia-style video-to-retail embedding + catalog match")
    return pm
