"""The port's multi-tenant serving plane (``repro_torch.serving.tenancy``).

The JAX package's nine tenancy gates (``tests/test_tenancy.py``) in the
port; ``_flatten_to``'s pad and truncate cases; the two shipped pipelines'
cloud and fog stages against the JAX package's on the same frames (same
seeds, so the same weights); the pipeline catalog; and one three-tenant
sharded run against the JAX package's.  32 x 32 models from the JAX
package's inits, on the CPU."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro.core.protocol import HighLowProtocol as JProtocol
from repro.models import classifier as jclf
from repro.models import detector as jdet
from repro.serving import policies as jpolicies
from repro.serving import tenancy as jten
from repro.serving.batching import CrossStreamBatcher as JBatcher
from repro.serving.graph import VideoFunctionGraph as JGraph
from repro.serving.shards import ShardedScheduler as JSharded
from repro_torch import weights
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.core.bandwidth import FOG
from repro_torch.core.incremental import IncrementalLearner
from repro_torch.core.protocol import HighLowProtocol
from repro_torch.serving import policies
from repro_torch.serving.autoscaler import CostAwareAutoscaler
from repro_torch.serving.batching import CrossStreamBatcher
from repro_torch.serving.executor import Executor
from repro_torch.serving.graph import GraphScheduler, VideoFunctionGraph
from repro_torch.serving.ingest import ArtifactStore
from repro_torch.serving.registry import FunctionRegistry
from repro_torch.serving.shards import ShardedScheduler
from repro_torch.serving.tenancy import (BRONZE, GOLD, SILVER, BillingRates,
                                         CostModel, Tenancy, TenantSpec,
                                         _flatten_to, content_pipeline,
                                         llm_cascade_pipeline)
from repro_torch.testing import MODEL_ATOL, report_mismatches
from repro_torch.video import synthetic

torch.set_num_threads(1)

DET = DetectorConfig(name="tenancy-test-det", image_hw=(32, 32),
                     widths=(8, 16))
CLF = ClassifierConfig(name="tenancy-test-clf", crop_hw=(16, 16),
                       widths=(8, 16), feature_dim=16)
T_DET = tcfg.DetectorConfig(name="tenancy-test-det", image_hw=(32, 32),
                            widths=(8, 16))
T_CLF = tcfg.ClassifierConfig(name="tenancy-test-clf", crop_hw=(16, 16),
                              widths=(8, 16), feature_dim=16)
# the pipelines' outputs, JAX vs port: float32 matmuls over 3,072 inputs
# summed in another order
PIPE_ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jd = jdet.init_detector(DET, jax.random.PRNGKey(0))
    jc = jclf.init_classifier(CLF, jax.random.PRNGKey(1))
    return (jd, jc, weights.from_numpy_tree(jd, "cpu"),
            weights.from_numpy_tree(jc, "cpu"))


def _chunks(seed, n, frames=2):
    rng = np.random.default_rng(seed)
    return [synthetic.make_chunk(rng, "traffic", num_frames=frames,
                                 hw=(32, 32)) for _ in range(n)]


def _graph(models):
    return VideoFunctionGraph(HighLowProtocol(T_DET, T_CLF, device="cpu"),
                              models[2], models[3]), models[3]


def _drain(sched, states, streams, learn=False):
    for st, chunks in zip(states, streams):
        for c in chunks:
            sched.submit(st, c, learn=learn)
    sched.run_until_idle()


def _pipes(tag, device="cpu"):
    return (llm_cascade_pipeline(name=f"t-cascade-{tag}", device=device),
            content_pipeline(name=f"t-retail-{tag}", device=device))


# ---------------------------------------------------------------------------
# the JAX package's nine gates
# ---------------------------------------------------------------------------
def test_default_path_bitwise_identity(models):
    graph, clf_params = _graph(models)
    streams = [_chunks(700 + i, 3) for i in range(4)]
    plain = GraphScheduler(
        graph, batcher=CrossStreamBatcher(max_chunks=4, window=0.05),
        hot_path="fused")
    sa = [plain.add_stream(f"cam{i}", W=clf_params["W"], slo=5.0)
          for i in range(4)]
    _drain(plain, sa, streams)
    spec = TenantSpec("vision", GOLD, weight=1.0)
    tenant = GraphScheduler(
        graph, batcher=CrossStreamBatcher(max_chunks=4, window=0.05),
        hot_path="fused", cost_model=CostModel())
    sb = [tenant.add_stream(f"cam{i}", W=clf_params["W"], slo=5.0,
                            tenant=spec) for i in range(4)]
    _drain(tenant, sb, streams)
    for x, y in zip(sa, sb):
        assert len(x.results) == len(y.results)
        for (c1, r1, m1), (c2, r2, m2) in zip(x.results, y.results):
            assert c1 is c2 and m1 == m2
            for name in ("boxes", "labels", "valid", "fog_scores"):
                np.testing.assert_array_equal(getattr(r1, name),
                                              getattr(r2, name))
            assert r1.latency.total == r2.latency.total
            assert (r1.wan_bytes, r1.coord_bytes) == (r2.wan_bytes,
                                                      r2.coord_bytes)
    ra, rb = plain.throughput_report(), tenant.throughput_report()
    assert report_mismatches(ra, rb, ignore={"cost", "tenants"}) == []
    assert set(rb["tenants"]) == {"vision"}
    assert rb["tenants"]["vision"]["chunks"] == sum(len(s) for s in streams)


def test_cost_ledger_conservation(models):
    graph, clf_params = _graph(models)
    cost = CostModel()
    sched = GraphScheduler(
        graph, batcher=CrossStreamBatcher(max_chunks=4, window=0.05),
        hot_path="fused", cost_model=cost,
        store=ArtifactStore(ttl=5.0, capacity_bytes=1.0))
    casc, retail = _pipes("led")
    ten = Tenancy(graph, cost)
    ten.register(TenantSpec("vision", GOLD, weight=4.0))
    ten.register(TenantSpec("cascade", SILVER, weight=2.0, pipeline=casc))
    ten.register(TenantSpec("retail", BRONZE, weight=1.0,
                            rates=BillingRates(cloud_replica_s=0.002),
                            pipeline=retail))
    states = [ten.add_stream(sched, t, f"cam-{t}",
                             **({"W": clf_params["W"]} if t == "vision"
                                else {}))
              for t in ("vision", "cascade", "retail")]
    _drain(sched, states, [_chunks(800 + i, 3) for i in range(3)])
    cost.close(max(s.clock for s in states))
    cr = sched.throughput_report()["cost"]
    per_tenant = math.fsum(v["total_usd"] for v in cr["tenants"].values())
    assert np.isclose(per_tenant, cr["total_usd"], rtol=1e-12)
    assert cr["total_usd"] > 0
    assert sum(v["chunks"] for v in cr["tenants"].values()) == 9
    assert set(cr["tenants"]) == {"vision", "cascade", "retail"}
    assert np.isclose(cr["provisioned_replica_s"],
                      cr["busy_replica_s"] + cr["idle_replica_s"])
    for v in cr["tenants"].values():
        assert v["frames"] > 0 and v["cost_per_mframes"] > 0
    assert cr["tenants"]["cascade"]["invocations"] <= \
        cr["tenants"]["cascade"]["frames"]
    sched.drain()


def test_wfq_share_conservation_under_overload(models):
    graph, clf_params = _graph(models)
    sched = GraphScheduler(
        graph, batcher=CrossStreamBatcher(max_chunks=1, window=10.0),
        hot_path="fused", cost_model=CostModel(), deadline_batching=False)
    heavy = TenantSpec("heavy", BRONZE, weight=3.0)
    light = TenantSpec("light", BRONZE, weight=1.0)
    shared = _chunks(900, 8)
    sa = sched.add_stream("cam-heavy", W=clf_params["W"], weight=3.0,
                          tenant=heavy)
    sb = sched.add_stream("cam-light", W=clf_params["W"], weight=1.0,
                          tenant=light)
    _drain(sched, [sa, sb], [shared, list(shared)])
    lat_h = [r.latency.total for _, r, _ in sa.results]
    lat_l = [r.latency.total for _, r, _ in sb.results]
    assert len(lat_h) == len(lat_l) == 8
    assert np.mean(lat_h) <= np.mean(lat_l)
    assert sched.sched_stats["finalizes"] == 16


def test_executor_background_lane_never_blocks_serving():
    reg = FunctionRegistry()
    reg.register("work", lambda: "ok", kind="test")
    ex = Executor("fog-x", reg, FOG)
    _, done_bg = ex.run("work", now=0.0, model_time=5.0,
                        priority="background")
    assert done_bg == 5.0
    _, done_serve = ex.run("work", now=1.0, model_time=1.0)
    assert done_serve == 2.0
    ex2 = Executor("fog-y", reg, FOG)
    ex2.run("work", now=0.0, model_time=5.0)
    _, done_blocked = ex2.run("work", now=1.0, model_time=1.0)
    assert done_blocked == 6.0
    _, done_bg2 = ex.run("work", now=1.0, model_time=1.0,
                         priority="background")
    assert done_bg2 == 6.0


def test_hitl_cost_never_delays_chunks(models):
    graph, clf_params = _graph(models)

    def run(hitl_cost_s):
        sched = GraphScheduler(
            graph, batcher=CrossStreamBatcher(max_chunks=2, window=0.05),
            hot_path="fused", hitl_cost_s=hitl_cost_s)
        st = sched.add_stream(
            "cam0", W=clf_params["W"],
            learner=IncrementalLearner(num_classes=T_CLF.num_classes,
                                       trigger=4, budget=64,
                                       rule="proximal"))
        for c in _chunks(910, 4):
            sched.submit(st, c, learn=True)
        sched.run_until_idle()
        return [r.latency.total for _, r, _ in st.results], st

    lat_free, _ = run(0.0)
    lat_priced, st = run(5.0)
    assert lat_free == lat_priced
    assert any(r.device.endswith("/bg") and r.duration == 5.0
               for r in st.fog_exec.records)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_store_capacity_spills(kind):
    wrap = (lambda a: a) if kind == "numpy" else torch.as_tensor
    store = ArtifactStore(ttl=100.0, capacity_bytes=3000.0)
    for i in range(4):
        ref = store.put(wrap(np.full((16, 16), i, np.float32)), key=f"k{i}",
                        now=float(i))
        store.release(ref, now=float(i))
    assert store.stats["spills"] == 2
    assert store.stats["spill_bytes"] == 2048.0
    assert store.stats["bytes_current"] <= 3000.0
    assert store.stats["evictions"] == 2
    held = ArtifactStore(ttl=100.0, capacity_bytes=1000.0)
    keep = [held.put(wrap(np.full((16, 16), i, np.float32)), key=f"h{i}",
                     now=0.0) for i in range(3)]
    assert held.stats["spills"] == 0 and len(held) == 3
    for r in keep:
        held.release(r, now=0.0)
    held.put(wrap(np.zeros((16, 16), np.float32)), key="h3", now=1.0)
    assert held.stats["spills"] > 0
    cost = CostModel(BillingRates(spill_per_gb=2.0))
    cost.register(TenantSpec("t", BRONZE))
    cost.charge_egress("t", 100.0, 0.0)
    cost.observe_pool(0.0, 0)
    rep = cost.cost_report(held.report())
    assert rep["spill_bytes"] == held.stats["spill_bytes"]
    assert np.isclose(rep["spill_cost"],
                      held.stats["spill_bytes"] / 1e9 * 2.0)
    assert np.isclose(rep["tenants"]["t"]["spill_cost"], rep["spill_cost"])


def test_store_spills_surface_in_throughput_report(models):
    graph, clf_params = _graph(models)
    sched = GraphScheduler(
        graph, batcher=CrossStreamBatcher(max_chunks=1, window=0.0),
        hot_path="fused", store=ArtifactStore(ttl=100.0, capacity_bytes=1.0))
    st = sched.add_stream("cam0", W=clf_params["W"])
    for c in _chunks(920, 3):
        sched.submit(st, c, learn=False)
    sched.run_until_idle()
    rep = sched.throughput_report()
    assert rep["store_spills"] >= 1
    assert rep["store"]["spill_bytes"] > 0
    assert len(st.results) == 3


def test_cost_aware_autoscaler_policy():
    sc = CostAwareAutoscaler(min_devices=1, max_devices=8,
                             replica_rate_usd_s=0.01, miss_value_usd=0.05,
                             frame_service_s=0.1, slo_slack_s=1.0,
                             cold_start_s=0.2, ewma_alpha=1.0)
    assert sc.decide(0.0, 40, 1) == 5
    assert sc.decide(1.0, 0, 5) == 5
    assert sc.decide(4.0, 0, 5) == 5
    assert sc.decide(6.5, 0, 5) == 4
    assert sc.decide(7.0, 0, 4) == 4
    assert sc.decide(12.0, 0, 4) == 3
    assert sc.decide(13.0, 10_000, 3) == 8
    s = sc.summary()
    assert s["peak_devices"] == 8 and s["scale_downs"] == 2


def _three_tenants(sched, graph, cost, pipes, W):
    ten = Tenancy(graph, cost)
    ten.register(TenantSpec("vision", GOLD, weight=4.0))
    ten.register(TenantSpec("cascade", SILVER, weight=2.0,
                            pipeline=pipes[0]))
    ten.register(TenantSpec("retail", BRONZE, weight=1.0,
                            pipeline=pipes[1]))
    return [ten.add_stream(sched, t, f"cam{i}",
                           **({"W": W} if t == "vision" else {}))
            for i, t in enumerate(("vision", "cascade", "retail", "vision"))]


def test_tenant_pipelines_share_fleet_sharded(models):
    graph, clf_params = _graph(models)
    cost = CostModel()
    sched = ShardedScheduler(
        graph, num_shards=2,
        batcher_factory=lambda i: CrossStreamBatcher(max_chunks=4,
                                                     window=0.05),
        hot_path="fused", cost_model=cost)
    states = _three_tenants(sched, graph, cost, _pipes("shard"),
                            clf_params["W"])
    assert "cloud.tenant.t-cascade-shard" in graph.registry
    assert "fog.tenant.t-retail-shard" in graph.registry
    _drain(sched, states, [_chunks(930 + i, 3) for i in range(4)])
    cost.close(max(s.clock for s in states))
    rep = sched.throughput_report()
    assert set(rep["tenants"]) == {"vision", "cascade", "retail"}
    assert rep["tenants"]["vision"]["chunks"] == 6
    cr = rep["cost"]
    assert np.isclose(math.fsum(v["total_usd"]
                                for v in cr["tenants"].values()),
                      cr["total_usd"], rtol=1e-12)
    for st in states:
        assert len(st.results) == 3
        if st.tenant.pipeline is not None:
            assert st.results[0][1].outputs["frames"] == 2
    for v in rep["tenants"].values():
        assert 0.0 <= v["slo_attainment"] <= 1.0
    sched.drain()


# ---------------------------------------------------------------------------
# the pipelines against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", [5, 12, 20])
def test_flatten_to_pads_or_truncates(width):
    x = np.random.default_rng(width).random((3, 2, 2, 3), dtype=np.float32)
    got = _flatten_to(torch.as_tensor(x), width)
    want = np.asarray(jten._flatten_to(jnp.asarray(x), width))
    assert got.shape == (3, width) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert _flatten_to(torch.as_tensor(x).double(), 4).dtype == torch.float32


def _frames(seed, n, hw):
    return np.random.default_rng(seed).random((n,) + hw + (3,),
                                              dtype=np.float32)


def _near_tie(values, atol):
    top2 = np.sort(values, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= 2 * atol


def _little_logits(chunk, seed=7, d_model=32, n_classes=16):
    """The cascade's fog model in numpy, from the constructor's draws (w_in,
    then w_little) on the first 3,072 features of each frame."""
    in_dim = 32 * 32 * 3
    rng = np.random.default_rng(seed)
    w_in = rng.normal(0.0, 1.0 / math.sqrt(in_dim), (in_dim, d_model))
    w_little = rng.normal(0.0, 1.0 / math.sqrt(d_model),
                          (d_model, n_classes))
    flat = chunk.reshape(chunk.shape[0], -1)[:, :in_dim].astype(np.float64)
    return flat @ w_in.astype(np.float32) @ w_little.astype(np.float32)


@pytest.mark.parametrize("hw", [(32, 32), (26, 26), (40, 40)])
def test_cascade_pipeline_matches_jax(hw):
    # a low-quality cloud batch (rescaled, so padded or cut to the input
    # width) and the HQ chunk at the fog merge
    jp = jten.llm_cascade_pipeline()
    tp = llm_cascade_pipeline(device="cpu")
    batch, chunk = _frames(1, 6, hw), _frames(2, 6, (32, 32))
    jout = np.asarray(jp.cloud_fn(jnp.asarray(batch)))
    tout = tp.cloud_fn(torch.as_tensor(batch))
    assert isinstance(tout, torch.Tensor) and tout.shape == jout.shape
    np.testing.assert_allclose(tout.numpy(), jout, atol=PIPE_ATOL, rtol=0)
    assert np.array_equal(tp.cloud_fn(batch).numpy(), tout.numpy())
    jres = jp.fog_fn(chunk, jout)
    tres = tp.fog_fn(chunk, tout)
    assert tres.keys() == jres.keys() and tres["frames"] == 6
    assert tres["answers"].dtype == np.int32
    # escalation follows the little model's top-2 probability margin, the
    # answer the escalated big or the little logits: equal away from ties
    lil = _little_logits(chunk)
    e = np.exp(lil - lil.max(-1, keepdims=True))
    top2 = np.sort(e / e.sum(-1, keepdims=True), -1)[:, -2:]
    margin_tie = np.abs(top2[:, 1] - top2[:, 0] - 0.25) <= 1e-5
    tie = margin_tie | _near_tie(jout, PIPE_ATOL) | _near_tie(lil, PIPE_ATOL)
    assert (tres["answers"] == jres["answers"])[~tie].all()
    if not margin_tie.any():
        assert tres["escalated"] == jres["escalated"]
    assert tp.billed(tres, 6) == tres["escalated"]
    assert tp.out_bytes(tres, 6) == jp.out_bytes(jres, 6) == 24.0


@pytest.mark.parametrize("hw", [(32, 32), (26, 26)])
def test_content_pipeline_matches_jax(hw):
    jp = jten.content_pipeline()
    tp = content_pipeline(device="cpu")
    batch = _frames(3, 5, hw)
    jemb = np.asarray(jp.cloud_fn(jnp.asarray(batch)))
    temb = tp.cloud_fn(torch.as_tensor(batch))
    np.testing.assert_allclose(temb.numpy(), jemb, atol=PIPE_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(temb.numpy(), axis=1), 1.0,
                               atol=1e-5)
    jres = jp.fog_fn(None, jemb)
    tres = tp.fog_fn(None, temb)
    assert tres["frames"] == jres["frames"] == 5
    assert tres["products"].dtype == np.int32
    assert tres["scores"].dtype == np.float32
    np.testing.assert_allclose(tres["scores"], jres["scores"], atol=1e-5)
    # the catalog from the constructor's draws: ids equal away from ties
    rng = np.random.default_rng(11)
    rng.normal(size=(32 * 32 * 3, 24))
    catalog = rng.normal(0.0, 1.0, (64, 24))
    catalog /= np.linalg.norm(catalog, axis=1, keepdims=True)
    tie = _near_tie(jemb @ catalog.T, 1e-5)
    assert (tres["products"] == jres["products"])[~tie].all()


def test_pipelines_draw_the_reference_weights():
    # the same numpy draws: the big model's logits on a one-hot probe agree
    # to float32 rounding with the JAX package's
    probe = np.eye(8, 32 * 32 * 3, dtype=np.float32)
    for jb, tb in ((jten.llm_cascade_pipeline, llm_cascade_pipeline),
                   (jten.content_pipeline, content_pipeline)):
        for seed in (7, 11, 3):
            want = np.asarray(jb(seed=seed).cloud_fn(jnp.asarray(probe)))
            got = tb(seed=seed, device="cpu").cloud_fn(probe).numpy()
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_default_tenant_pipelines_catalog():
    pm = policies.default_tenant_pipelines()
    assert pm.list() == jpolicies.default_tenant_pipelines().list()
    assert pm.build("detection") is None
    casc = pm.build("llm-cascade", device="cpu")
    assert casc.cloud_stage == "cloud.tenant.llm-cascade"
    assert pm.build("retail-content", device="cpu").name == "retail-content"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pm.build("llm-cascade")             # device="cuda" by default


def _tenant_run(pkg, models, streams):
    """Three tenants (vision GOLD, cascade SILVER, retail BRONZE) on a
    2-shard fleet of one package; returns the streams and the report."""
    jd, jc, td, tc = models
    if pkg == "jax":
        graph = JGraph(JProtocol(DET, CLF), jd, jc)
        mod, W = jten, jc["W"]
        cost = jten.CostModel()
        sched = JSharded(graph, num_shards=2, cost_model=cost,
                         batcher_factory=lambda i: JBatcher(max_chunks=4,
                                                            window=0.05),
                         hot_path="fused")
        pipes = (jten.llm_cascade_pipeline(name="p-casc"),
                 jten.content_pipeline(name="p-retail"))
    else:
        graph = VideoFunctionGraph(
            HighLowProtocol(T_DET, T_CLF, device="cpu"), td, tc)
        mod, W = None, tc["W"]
        cost = CostModel()
        sched = ShardedScheduler(
            graph, num_shards=2, cost_model=cost, hot_path="fused",
            batcher_factory=lambda i: CrossStreamBatcher(max_chunks=4,
                                                         window=0.05))
        pipes = (llm_cascade_pipeline(name="p-casc", device="cpu"),
                 content_pipeline(name="p-retail", device="cpu"))
    ten = (mod.Tenancy if mod else Tenancy)(graph, cost)
    spec = mod.TenantSpec if mod else TenantSpec
    gold, silver, bronze = ((mod.GOLD, mod.SILVER, mod.BRONZE) if mod
                            else (GOLD, SILVER, BRONZE))
    ten.register(spec("vision", gold, weight=4.0))
    ten.register(spec("cascade", silver, weight=2.0, pipeline=pipes[0]))
    ten.register(spec("retail", bronze, weight=1.0, pipeline=pipes[1]))
    states = [ten.add_stream(sched, t, f"cam{i}",
                             **({"W": W} if t == "vision" else {}))
              for i, t in enumerate(("vision", "cascade", "retail",
                                     "vision"))]
    _drain(sched, states, streams)
    cost.close(max(s.clock for s in states))
    return states, sched.throughput_report()


def test_three_tenant_sharded_run_matches_jax(models):
    # the same fleet in both packages: vision answers within MODEL_ATOL,
    # the pipelines' answers and product ids equal, scores within 1e-5,
    # and the cost ledger's counters equal
    streams = [_chunks(930 + i, 3) for i in range(4)]
    js, jr = _tenant_run("jax", models, streams)
    ts, tr = _tenant_run("port", models, streams)
    for a, b in zip(js, ts):
        assert len(a.results) == len(b.results) == 3
        for (c1, r1, m1), (c2, r2, m2) in zip(a.results, b.results):
            assert c1 is c2 and m1 == m2
            if a.tenant.pipeline is None:
                np.testing.assert_array_equal(r2.labels, r1.labels)
                np.testing.assert_allclose(r2.fog_scores, r1.fog_scores,
                                           atol=MODEL_ATOL, rtol=0)
            elif "answers" in r1.outputs:
                np.testing.assert_array_equal(r2.outputs["answers"],
                                              r1.outputs["answers"])
                assert r2.outputs["escalated"] == r1.outputs["escalated"]
            else:
                np.testing.assert_array_equal(r2.outputs["products"],
                                              r1.outputs["products"])
                np.testing.assert_allclose(r2.outputs["scores"],
                                           r1.outputs["scores"], atol=1e-5)
    for name, v in jr["cost"]["tenants"].items():
        w = tr["cost"]["tenants"][name]
        for k in ("frames", "invocations", "chunks"):
            assert w[k] == v[k], (name, k)
        np.testing.assert_allclose(w["total_usd"], v["total_usd"], rtol=1e-4)
    assert tr["steals"] == jr["steals"]
