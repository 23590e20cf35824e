"""Multi-tenant pipeline-as-a-service: tenant specs, pipelines, and the
monetary cost model (the source paper's §VI economics + Hysia-style
pipeline sharing, arXiv 2006.05117).

The serving substrate — :class:`~repro_torch.serving.registry.FunctionRegistry`,
:class:`~repro_torch.serving.executor.Executor` fleet, the shared detector
replica pool behind :class:`~repro_torch.serving.router.Router`, and the WFQ
:class:`~repro_torch.serving.batching.CrossStreamBatcher` — was built for one
implicit tenant running the High-Low video pipeline.  This module makes
tenancy explicit:

* :class:`TenantSpec` names a tenant's function graph (``pipeline``), SLO
  class, WFQ weight, and billing rates.  A spec with ``pipeline=None``
  runs the default High-Low detection-analytics graph; a spec carrying a
  :class:`TenantPipeline` registers its own cloud/fog stage functions on
  the *shared* registry and executes them on the *shared* replica pool and
  fog executors through the ordinary ``GraphScheduler`` /
  ``ShardedScheduler`` event loop (flush assembly partitions a WFQ batch
  by pipeline, so cross-tenant fairness is decided *before* pipelines
  diverge).
* :class:`TenantPipeline` is the shape every shipped pipeline shares:
  a batchable cloud stage (heavy model) and a per-stream fog merge stage,
  with service-time and billing models.  Constructors:
  :func:`llm_cascade_pipeline` (the ``examples/llm_cascade_serving.py``
  big/little cascade — the cloud big model is billed only for frames the
  fog little model escalates) and :func:`content_pipeline` (a Hysia-style
  video-to-retail content match: cloud embedding + fog catalog search).
  Their weights are drawn with numpy from the same seeds as the JAX
  package's, so both packages hold identical weights.
* :class:`CostModel` meters per-tenant spend on the simulated clock:
  replica-seconds at cloud/fog rates (busy time attributed per dispatch,
  provisioned-but-idle keep-alive time integrated from the router's pool
  trace and apportioned by usage), per-frame serverless invocations, and
  egress bytes from the ArtifactStore/WAN ledger, plus the store's
  spill-cost when a capacity-bounded store evicts under pressure.
  ``cost_report()`` rolls this up per tenant and fleet-wide with
  cost-per-million-frames; the ledger conserves by construction (the sum
  of per-tenant spend IS the fleet spend — tested).

Single-tenant defaults are untouched: a scheduler without a
``cost_model`` and without tenant-tagged streams takes exactly the
pre-tenancy code paths (bitwise-identical output — gated in
``bench_tenancy.py`` and ``tests/test_tenancy.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.core.bandwidth import LatencyBreakdown
from repro_torch.core.protocol import to_host

__all__ = [
    "BillingRates", "SLOClass", "GOLD", "SILVER", "BRONZE",
    "TenantPipeline", "TenantSpec", "TenantChunkResult", "CostModel",
    "Tenancy", "llm_cascade_pipeline", "content_pipeline",
]


# ---------------------------------------------------------------------------
# Billing + SLO classes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BillingRates:
    """Price book in $ per unit of simulated resource.

    Defaults are loosely shaped on public serverless-GPU pricing (a
    V100-class replica ~ $14/h ≈ $0.004/s; per-invocation billing per
    million requests; egress per GB).  The *fleet* price book lives on the
    :class:`CostModel`; a :class:`TenantSpec` may carry its own rates for
    that tenant's direct-usage charges (a discounted or premium contract)."""
    cloud_replica_s: float = 0.004     # $ / cloud replica-second (keep-alive)
    fog_s: float = 0.0008              # $ / fog executor busy-second
    invoke_per_mframe: float = 4.0     # $ / million per-frame invocations
    egress_per_gb: float = 0.09        # $ / GB leaving a tier
    spill_per_gb: float = 0.02         # $ / GB the store spills under pressure


@dataclass(frozen=True)
class SLOClass:
    """A named latency class: per-chunk SLO plus the isolation contract.

    ``isolation_factor`` bounds how far this class's p99 latency may
    inflate when *another* tenant floods the shared fleet (the
    noisy-neighbor gate in ``bench_tenancy.py``)."""
    name: str
    slo_s: Optional[float]             # per-chunk latency target (None = BE)
    isolation_factor: float = 1.5


GOLD = SLOClass("gold", 2.0, isolation_factor=1.25)
SILVER = SLOClass("silver", 4.0, isolation_factor=1.5)
BRONZE = SLOClass("bronze", 8.0, isolation_factor=2.0)


# ---------------------------------------------------------------------------
# Tenant pipelines (distinct function graphs on the shared substrate)
# ---------------------------------------------------------------------------
@dataclass
class TenantPipeline:
    """A non-default tenant function graph: one batchable cloud stage and
    one per-stream fog merge stage, both registered on the shared
    :class:`FunctionRegistry` and executed on the shared fleet.

    ``cloud_fn(batch) -> out`` runs on a detector-pool replica (padded
    cross-stream batch, service time ``frames / cloud_fps``);
    ``fog_fn(chunk_frames, out_slice) -> dict`` runs on the stream's own
    fog executor.  ``billed_frames`` maps the fog output to the number of
    *billable* cloud invocations for the chunk (the cascade bills only
    escalated frames); ``result_bytes`` models the result payload returned
    downstream (the egress ledger's analogue of coord bytes)."""
    name: str
    cloud_stage: str
    fog_stage: str
    cloud_fn: Callable[..., Any]
    fog_fn: Callable[..., Dict[str, Any]]
    cloud_fps: float = 300.0
    fog_fps: float = 600.0
    billed_frames: Optional[Callable[[Dict[str, Any], int], int]] = None
    result_bytes: Optional[Callable[[Dict[str, Any], int], float]] = None

    def billed(self, out: Dict[str, Any], frames: int) -> int:
        return int(self.billed_frames(out, frames)
                   if self.billed_frames is not None else frames)

    def out_bytes(self, out: Dict[str, Any], frames: int) -> float:
        return float(self.result_bytes(out, frames)
                     if self.result_bytes is not None else 8.0 * frames)


def _flatten_to(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Flatten (B, ...) to (B, dim), truncating or zero-padding features.

    The fog encode stage may rescale frames before the cloud stage sees
    them, so a pipeline's input width can't be assumed."""
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    d = flat.shape[1]
    if d >= dim:
        return flat[:, :dim]
    return torch.nn.functional.pad(flat, (0, dim - d))


def _normal(rng: np.random.Generator, shape, fan_in: int) -> np.ndarray:
    return rng.normal(0.0, 1.0 / math.sqrt(fan_in), shape).astype(np.float32)


def llm_cascade_pipeline(*, name: str = "llm-cascade",
                         image_hw: Tuple[int, int] = (32, 32),
                         d_model: int = 32, n_classes: int = 16,
                         big_mult: int = 4, escalate_margin: float = 0.25,
                         cloud_fps: float = 150.0, fog_fps: float = 900.0,
                         seed: int = 7, device="cuda") -> TenantPipeline:
    """The ``examples/llm_cascade_serving.py`` big/little cascade as a
    tenant graph: the fog little model answers every frame and flags
    low-margin ones; the cloud big model's (batched, speculative) answers
    replace the flagged frames at the fog merge.  Serverless billing
    counts only the *escalated* frames as cloud invocations — the
    cascade's whole economic point.  The weights live on ``device``."""
    dev = require_device(device)
    in_dim = image_hw[0] * image_hw[1] * 3
    rng = np.random.default_rng(seed)
    w_in, w_little, w_big1, w_big2 = (
        torch.as_tensor(_normal(rng, shape, shape[0]), device=dev)
        for shape in ((in_dim, d_model), (d_model, n_classes),
                      (d_model, d_model * big_mult),
                      (d_model * big_mult, n_classes)))

    def cloud_fn(batch) -> torch.Tensor:
        x = _flatten_to(torch.as_tensor(batch, device=dev), in_dim) @ w_in
        return torch.relu(x @ w_big1) @ w_big2

    def fog_fn(chunk_frames, big_logits) -> Dict[str, Any]:
        frames = torch.as_tensor(chunk_frames, device=dev)
        lil_t = _flatten_to(frames, in_dim) @ w_in @ w_little
        lil = lil_t.cpu().numpy()
        probs = torch.softmax(lil_t, dim=-1).cpu().numpy()
        top2 = np.sort(probs, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        esc = margin < escalate_margin
        big = to_host(big_logits)
        logits = np.where(esc[:, None], big, lil)
        return {"answers": logits.argmax(-1).astype(np.int32),
                "escalated": int(esc.sum()), "frames": int(lil.shape[0])}

    return TenantPipeline(
        name=name, cloud_stage=f"cloud.tenant.{name}",
        fog_stage=f"fog.tenant.{name}", cloud_fn=cloud_fn, fog_fn=fog_fn,
        cloud_fps=cloud_fps, fog_fps=fog_fps,
        billed_frames=lambda out, f: out["escalated"],
        result_bytes=lambda out, f: 4.0 * f)


def content_pipeline(*, name: str = "retail-content",
                     image_hw: Tuple[int, int] = (32, 32),
                     embed_dim: int = 24, n_products: int = 64,
                     cloud_fps: float = 400.0, fog_fps: float = 700.0,
                     seed: int = 11, device="cuda") -> TenantPipeline:
    """Hysia-style video-to-retail content pipeline: a cloud embedding
    backbone (batchable matmul) plus a fog product-catalog cosine match
    returning the best product id + score per frame.  The weights and the
    catalog live on ``device``."""
    dev = require_device(device)
    in_dim = image_hw[0] * image_hw[1] * 3
    rng = np.random.default_rng(seed)
    w_embed = torch.as_tensor(_normal(rng, (in_dim, embed_dim), in_dim),
                              device=dev)
    catalog = rng.normal(0.0, 1.0, (n_products, embed_dim)).astype(np.float32)
    catalog /= np.linalg.norm(catalog, axis=1, keepdims=True)
    catalog_dev = torch.as_tensor(catalog, device=dev)

    def cloud_fn(batch) -> torch.Tensor:
        x = _flatten_to(torch.as_tensor(batch, device=dev), in_dim) @ w_embed
        return x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-8)

    def fog_fn(chunk_frames, emb_slice) -> Dict[str, Any]:
        sims = torch.as_tensor(emb_slice, device=dev) @ catalog_dev.T
        scores, ids = sims.max(dim=1)
        return {"products": ids.cpu().numpy().astype(np.int32),
                "scores": scores.cpu().numpy().astype(np.float32),
                "frames": int(emb_slice.shape[0])}

    return TenantPipeline(
        name=name, cloud_stage=f"cloud.tenant.{name}",
        fog_stage=f"fog.tenant.{name}", cloud_fn=cloud_fn, fog_fn=fog_fn,
        cloud_fps=cloud_fps, fog_fps=fog_fps,
        result_bytes=lambda out, f: 8.0 * f)


@dataclass
class TenantSpec:
    """One tenant: function graph, SLO class, WFQ weight, billing rates.

    ``pipeline=None`` means the default High-Low detection-analytics
    graph (the paper's pipeline); streams of such a tenant take exactly
    the pre-tenancy scheduler code paths.  ``rates=None`` bills the
    tenant at the fleet price book."""
    name: str
    slo_class: SLOClass = BRONZE
    weight: float = 1.0
    rates: Optional[BillingRates] = None
    pipeline: Optional[TenantPipeline] = None


class TenantChunkResult:
    """Duck-typed chunk result for custom tenant pipelines: carries the
    scalar fields the scheduler's finalize path reads (latency, byte and
    invocation accounting) plus the pipeline's output dict."""

    def __init__(self, outputs: Dict[str, Any], *, wan_bytes: float,
                 coord_bytes: float, cloud_frames: int,
                 latency: LatencyBreakdown):
        self.outputs = outputs
        self.wan_bytes = float(wan_bytes)
        self.coord_bytes = float(coord_bytes)
        self.cloud_frames = int(cloud_frames)
        self.latency = latency


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------
def _usage() -> Dict[str, float]:
    return {"frames": 0, "invocations": 0, "chunks": 0,
            "cloud_busy_s": 0.0, "fog_busy_s": 0.0, "egress_bytes": 0.0,
            "hedge_invocations": 0, "hedge_busy_s": 0.0}


class CostModel:
    """Per-tenant spend meter on the simulated clock.

    Direct usage (cloud busy replica-seconds, fog busy seconds, per-frame
    invocations, egress bytes) is charged to the owning tenant at that
    tenant's rates as it happens.  Fleet-level costs that no single
    dispatch owns — provisioned-but-idle replica keep-alive time
    (integrated from the router's pool-size trace) and store spill bytes —
    are priced at the fleet book and apportioned by usage share at report
    time, so the ledger conserves: ``sum(per-tenant total) == fleet
    total`` exactly (up to float summation)."""

    def __init__(self, rates: Optional[BillingRates] = None):
        self.rates = rates or BillingRates()
        self.tenants: Dict[str, TenantSpec] = {}
        self.usage: Dict[str, Dict[str, float]] = {}
        # (t, healthy_replicas) pool-size trace; appended by the router on
        # scale events and by the scheduler on dispatch — integrated
        # last-observation-carried-forward at report time
        self.pool_trace: List[Tuple[float, int]] = []
        # warm-pool prewarm spin-ups (scheduler's _warm_check): the
        # replica-seconds spent spinning up ahead of forecast demand.
        # Informational split like hedge_* — the time is already inside
        # the provisioned-pool integral, so pricing it here again would
        # break conservation; prewarm_cost below is the slice of the
        # keep-alive line attributable to prewarming, not a new line.
        self.prewarm: Dict[str, float] = {"spinups": 0, "replica_s": 0.0}

    # -- registration ----------------------------------------------------
    def register(self, spec: TenantSpec) -> TenantSpec:
        self.tenants[spec.name] = spec
        self.usage.setdefault(spec.name, _usage())
        return spec

    def _rates_of(self, tenant: str) -> BillingRates:
        spec = self.tenants.get(tenant)
        return (spec.rates if spec is not None and spec.rates is not None
                else self.rates)

    def _u(self, tenant: str) -> Dict[str, float]:
        return self.usage.setdefault(tenant, _usage())

    # -- metering --------------------------------------------------------
    def charge_cloud(self, tenant: str, *, frames: int, invocations: int,
                     busy_s: float, t: float) -> None:
        u = self._u(tenant)
        u["frames"] += int(frames)
        u["invocations"] += int(invocations)
        u["cloud_busy_s"] += float(busy_s)

    def charge_hedge(self, tenant: str, *, invocations: int, busy_s: float,
                     t: float) -> None:
        """Bill a hedged dispatch's speculative duplicate.

        A hedge is a real invocation occupying real device time whether or
        not it wins the race, so it flows into the same ``invocations`` /
        ``cloud_busy_s`` pools the pricing lines bill from (conservation
        holds with no special case); the ``hedge_*`` counters keep the
        robustness spend separately visible in :meth:`cost_report`."""
        u = self._u(tenant)
        u["invocations"] += int(invocations)
        u["cloud_busy_s"] += float(busy_s)
        u["hedge_invocations"] += int(invocations)
        u["hedge_busy_s"] += float(busy_s)

    def charge_fog(self, tenant: str, busy_s: float, t: float) -> None:
        self._u(tenant)["fog_busy_s"] += float(busy_s)

    def charge_egress(self, tenant: str, nbytes: float, t: float) -> None:
        self._u(tenant)["egress_bytes"] += float(nbytes)

    def note_chunk(self, tenant: str) -> None:
        self._u(tenant)["chunks"] += 1

    def observe_pool(self, t: float, healthy: int) -> None:
        self.pool_trace.append((float(t), int(healthy)))

    def note_prewarm(self, t: float, replicas: int, spinup_s: float) -> None:
        """Record a warm-pool prewarm actuation: ``replicas`` spun up at
        ``t``, each paying ``spinup_s`` of cold start off the data path."""
        self.prewarm["spinups"] += int(replicas)
        self.prewarm["replica_s"] += float(replicas) * float(spinup_s)

    def close(self, t: float) -> None:
        """Final pool observation at the end of the simulated run."""
        if self.pool_trace:
            self.observe_pool(max(t, self.pool_trace[-1][0]),
                              self.pool_trace[-1][1])
        else:
            self.observe_pool(t, 0)

    # -- rollup ----------------------------------------------------------
    def provisioned_replica_s(self) -> float:
        """∫ healthy-pool-size dt over the observed span (LOCF)."""
        trace = sorted(self.pool_trace)
        total = 0.0
        for (t0, n0), (t1, _) in zip(trace, trace[1:]):
            total += max(0.0, t1 - t0) * n0
        return total

    def cost_report(self, store: Optional[Dict[str, float]] = None
                    ) -> Dict[str, Any]:
        """Per-tenant and fleet spend with cost-per-million-frames."""
        names = sorted(set(self.usage) | set(self.tenants))
        direct: Dict[str, Dict[str, float]] = {}
        for name in names:
            u = self._u(name)
            r = self._rates_of(name)
            direct[name] = {
                "cloud_busy_cost": u["cloud_busy_s"] * r.cloud_replica_s,
                "fog_cost": u["fog_busy_s"] * r.fog_s,
                "invoke_cost": u["invocations"] / 1e6 * r.invoke_per_mframe,
                "egress_cost": u["egress_bytes"] / 1e9 * r.egress_per_gb,
            }
        # fleet keep-alive: provisioned replica time nobody's dispatch owns
        provisioned = self.provisioned_replica_s()
        busy_total = sum(self._u(n)["cloud_busy_s"] for n in names)
        idle_s = max(0.0, provisioned - busy_total)
        idle_cost = idle_s * self.rates.cloud_replica_s
        spill_bytes = float((store or {}).get("spill_bytes", 0.0))
        spill_cost = spill_bytes / 1e9 * self.rates.spill_per_gb

        def _shares(key: str) -> Dict[str, float]:
            tot = sum(self._u(n)[key] for n in names)
            if tot > 0:
                return {n: self._u(n)[key] / tot for n in names}
            active = [n for n in names if self._u(n)["frames"] > 0] or names
            return {n: (1.0 / len(active) if n in active else 0.0)
                    for n in names}

        idle_share = _shares("cloud_busy_s")
        spill_share = _shares("egress_bytes")
        out: Dict[str, Any] = {"tenants": {}}
        fleet_total = 0.0
        fleet_frames = 0
        for name in names:
            u = self._u(name)
            d = direct[name]
            keep_alive = idle_cost * idle_share[name]
            spill = spill_cost * spill_share[name]
            total = math.fsum(list(d.values()) + [keep_alive, spill])
            entry = dict(d)
            entry.update({
                "keep_alive_cost": keep_alive,
                "spill_cost": spill,
                "total_usd": total,
                "frames": int(u["frames"]),
                "invocations": int(u["invocations"]),
                "chunks": int(u["chunks"]),
                "cloud_busy_s": u["cloud_busy_s"],
                "fog_busy_s": u["fog_busy_s"],
                "egress_bytes": u["egress_bytes"],
                # robustness spend, already priced inside cloud_busy_cost /
                # invoke_cost above — informational split, not an extra line
                "hedge_invocations": int(u["hedge_invocations"]),
                "hedge_busy_s": u["hedge_busy_s"],
                "cost_per_mframes": (total / (u["frames"] / 1e6)
                                     if u["frames"] else 0.0),
            })
            out["tenants"][name] = entry
            fleet_total += total
            fleet_frames += int(u["frames"])
        out.update({
            "total_usd": fleet_total,
            "frames": fleet_frames,
            "cost_per_mframes": (fleet_total / (fleet_frames / 1e6)
                                 if fleet_frames else 0.0),
            "provisioned_replica_s": provisioned,
            "busy_replica_s": busy_total,
            "idle_replica_s": idle_s,
            "idle_cost": idle_cost,
            "spill_bytes": spill_bytes,
            "spill_cost": spill_cost,
            # warm-pool prewarming: informational split of the keep-alive
            # line (the spin-up replica-seconds are inside the provisioned
            # integral already — hedge_* pattern, conservation untouched)
            "prewarm_spinups": int(self.prewarm["spinups"]),
            "prewarm_replica_s": self.prewarm["replica_s"],
            "prewarm_cost": (self.prewarm["replica_s"]
                             * self.rates.cloud_replica_s),
        })
        return out


# ---------------------------------------------------------------------------
# Tenancy manager
# ---------------------------------------------------------------------------
class Tenancy:
    """Registers tenants (and their pipelines) on a shared graph substrate
    and tags their streams for the scheduler's per-tenant attribution."""

    def __init__(self, graph, cost_model: Optional[CostModel] = None):
        self.graph = graph
        self.cost = cost_model if cost_model is not None else CostModel()
        self.specs: Dict[str, TenantSpec] = {}

    def register(self, spec: TenantSpec) -> TenantSpec:
        self.specs[spec.name] = spec
        self.cost.register(spec)
        pipe = spec.pipeline
        if pipe is not None and pipe.cloud_stage not in self.graph.registry:
            # the tenant's function graph lands in the SHARED registry and
            # is deployed through the shared dispatcher — same substrate,
            # same executors, distinct stage functions
            self.graph.registry.register(
                pipe.cloud_stage, pipe.cloud_fn, kind="inference",
                tier="cloud", tenant=spec.name, batchable=True)
            self.graph.registry.register(
                pipe.fog_stage, pipe.fog_fn, kind="inference", tier="fog",
                tenant=spec.name)
            self.graph.dispatcher.dispatch("cloud", pipe.cloud_stage)
            self.graph.dispatcher.dispatch("fog", pipe.fog_stage)
        return spec

    def add_stream(self, sched, tenant: str, name: str, **kw):
        """Add a stream owned by ``tenant``; SLO and WFQ weight default to
        the tenant's class unless overridden.  Streams of a custom-pipeline
        tenant never touch the classifier readout, so ``W`` defaults to a
        placeholder there; default-pipeline tenants must pass their own."""
        spec = self.specs[tenant]
        kw.setdefault("slo", spec.slo_class.slo_s)
        kw.setdefault("weight", spec.weight)
        if spec.pipeline is not None:
            kw.setdefault("W", np.zeros((1, 1), np.float32))
        return sched.add_stream(name, tenant=spec, **kw)
