"""The port's chaos plane (``repro_torch.serving.fault``) with the
claim-check store holding tensor payloads: the JAX package's degradation
gates of ``tests/test_chaos.py`` (an idle injector is free, plainly and
sharded; a corrupted payload is detected and re-derived bitwise; a terminal
failure releases its claims; refcounts return to zero at drain), and one
flap-and-straggler run whose fault events equal the JAX package's.  32 x 32
models from the JAX package's inits, on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro.core.protocol import HighLowProtocol as JProtocol
from repro.models import classifier as jclf
from repro.models import detector as jdet
from repro.serving.batching import CrossStreamBatcher as JBatcher
from repro.serving.fault import FaultInjector as JFaultInjector
from repro.serving.graph import GraphScheduler as JScheduler
from repro.serving.graph import VideoFunctionGraph as JGraph
from repro_torch import weights
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.core.protocol import HighLowProtocol
from repro_torch.serving.batching import CrossStreamBatcher
from repro_torch.serving.fault import FaultInjector
from repro_torch.serving.graph import GraphScheduler, VideoFunctionGraph
from repro_torch.serving.ingest import ArtifactCorrupted, ArtifactStore
from repro_torch.serving.shards import ShardedScheduler
from repro_torch.testing import (LATENCY_RTOL, report_mismatches,
                                 results_mismatch)
from repro_torch.video import synthetic

torch.set_num_threads(1)

DET = DetectorConfig(name="chaos-test-det", image_hw=(32, 32),
                     widths=(8, 16))
CLF = ClassifierConfig(name="chaos-test-clf", crop_hw=(16, 16),
                       widths=(8, 16), feature_dim=16)
T_DET = tcfg.DetectorConfig(name="chaos-test-det", image_hw=(32, 32),
                            widths=(8, 16))
T_CLF = tcfg.ClassifierConfig(name="chaos-test-clf", crop_hw=(16, 16),
                              widths=(8, 16), feature_dim=16)
# tests/test_chaos.py's bitwise comparison: boxes, labels, valid, latency
ARRAYS = ("boxes", "labels", "valid")


@pytest.fixture(scope="module")
def models():
    jd = jdet.init_detector(DET, jax.random.PRNGKey(0))
    jc = jclf.init_classifier(CLF, jax.random.PRNGKey(1))
    return (jd, jc, weights.from_numpy_tree(jd, "cpu"),
            weights.from_numpy_tree(jc, "cpu"))


def _graph(models):
    return VideoFunctionGraph(HighLowProtocol(T_DET, T_CLF, device="cpu"),
                              models[2], models[3]), models[3]


def _chunks(seed, n, frames=2):
    rng = np.random.default_rng(seed)
    return [synthetic.make_chunk(rng, "traffic", num_frames=frames,
                                 hw=(32, 32)) for _ in range(n)]


def _sched(graph, cls=GraphScheduler, batcher=CrossStreamBatcher, **kw):
    kw.setdefault("batcher", batcher(max_chunks=4, window=0.05))
    kw.setdefault("hot_path", "fused")
    return cls(graph, **kw)


def _run(sched, add, streams, clf_params, slo=None):
    states = [add(f"cam{i}", W=clf_params["W"], slo=slo)
              for i in range(len(streams))]
    for st, chunks in zip(states, streams):
        for c in chunks:
            sched.submit(st, c, learn=False)
    sched.run_until_idle()
    return states


def _assert_bitwise(states_a, states_b):
    for a, b in zip(states_a, states_b):
        assert results_mismatch(a, b, arrays=ARRAYS) is None, a.name


def _network(graph):
    return graph.protocol.network


# ---------------------------------------------------------------------------
# integrity on tensor payloads
# ---------------------------------------------------------------------------
def test_store_integrity_detects_and_repairs_a_tensor():
    store = ArtifactStore(integrity=True)
    payload = torch.arange(32, dtype=torch.float32)
    ref = store.put(payload.clone(), key="k0")
    assert torch.equal(store.get(ref), payload)
    store.corrupt("k0")
    with pytest.raises(ArtifactCorrupted) as ei:
        store.get(ref)
    assert ei.value.key == "k0"
    assert store.stats["corruptions_detected"] == 1
    store.repair("k0", payload.clone())
    assert torch.equal(store.get(ref), payload)
    assert store.stats["corruptions_repaired"] == 1
    store.release(ref)
    assert store.live_refs() == {}


def test_store_without_integrity_serves_a_corrupted_tensor():
    store = ArtifactStore()
    payload = torch.arange(32, dtype=torch.float32)
    ref = store.put(payload.clone(), key="k0")
    store.corrupt("k0")
    assert not torch.equal(store.get(ref), payload)
    assert store.stats["corruptions_detected"] == 0


# ---------------------------------------------------------------------------
# the JAX package's gates in the port
# ---------------------------------------------------------------------------
def test_idle_injector_bitwise_identity(models):
    graph, clf_params = _graph(models)
    streams = [_chunks(400 + i, 3) for i in range(4)]
    plain = _sched(graph)
    sp = _run(plain, plain.add_stream, streams, clf_params, slo=0.5)
    idle = _sched(graph, fault=FaultInjector(network=_network(graph)))
    si = _run(idle, idle.add_stream, streams, clf_params, slo=0.5)
    _assert_bitwise(sp, si)
    assert report_mismatches(plain.throughput_report(),
                             idle.throughput_report()) == []
    assert idle.chaos_stats["hedges"] == 0


def test_idle_injector_identity_sharded(models):
    graph, clf_params = _graph(models)
    streams = [_chunks(430 + i, 3) for i in range(4)]

    def build(fault):
        sched = ShardedScheduler(
            graph, num_shards=2, store=ArtifactStore(integrity=True),
            batcher_factory=lambda i: CrossStreamBatcher(max_chunks=4,
                                                         window=0.05),
            hot_path="fused", cloud_replicas=2, fault=fault)
        return sched, _run(sched, sched.add_stream, streams, clf_params,
                           slo=0.5)

    plain, sp = build(None)
    idle, si = build(FaultInjector(network=_network(graph)))
    _assert_bitwise(sp, si)
    assert report_mismatches(plain.throughput_report(),
                             idle.throughput_report()) == []
    idle.drain()


@pytest.mark.parametrize("hot_path", ["fused", "sync"])
def test_corruption_detected_and_recovered_bitwise(models, hot_path):
    # the fused path stores tensors, the sync path numpy arrays
    graph, clf_params = _graph(models)
    streams = [_chunks(530 + i, 3) for i in range(4)]
    plain = _sched(graph, store=ArtifactStore(integrity=True),
                   hot_path=hot_path)
    sp = _run(plain, plain.add_stream, streams, clf_params)
    fi = FaultInjector(network=_network(graph))
    fi.inject_corruption(0.0, count=2)
    store = ArtifactStore(integrity=True)
    sched = _sched(graph, store=store, fault=fi, hot_path=hot_path)
    sc = _run(sched, sched.add_stream, streams, clf_params)
    assert fi.corruptions_injected == 2
    assert store.stats["corruptions_detected"] == 2
    assert sched.chaos_stats["corruptions_repaired"] == 2
    assert store.stats["corruptions_repaired"] == 2
    _assert_bitwise(sp, sc)
    sched.drain()


def test_terminal_failure_releases_claims(models):
    graph, clf_params = _graph(models)
    fi = FaultInjector(network=_network(graph))
    fi.fail_replica(0, 0.0)
    fi.fail_replica(1, 0.0)
    store = ArtifactStore(integrity=True)
    sched = _sched(graph, store=store, cloud_replicas=2, fault=fi)
    states = [sched.add_stream(f"cam{i}", W=clf_params["W"])
              for i in range(2)]
    for st, c in zip(states, _chunks(560, 2)):
        sched.submit(st, c, learn=False)
    with pytest.raises(RuntimeError, match="no healthy replicas"):
        sched.run_until_idle()
    assert store.live_refs() == {}


def test_drain_asserts_refcounts_return_to_zero(models):
    graph, clf_params = _graph(models)
    store = ArtifactStore(integrity=True)
    sched = _sched(graph, store=store)
    _run(sched, sched.add_stream, [_chunks(590, 2)], clf_params)
    sched.drain()
    store.put(torch.zeros(4), key="leaked")
    with pytest.raises(AssertionError, match="leaked"):
        sched.drain()


# ---------------------------------------------------------------------------
# one chaos run against the JAX package's
# ---------------------------------------------------------------------------
def _chaos_events(pkg, models):
    jd, jc, td, tc = models
    streams = [_chunks(460 + i, 3) for i in range(6)]
    if pkg == "jax":
        graph = JGraph(JProtocol(DET, CLF), jd, jc)
        fi = JFaultInjector(network=graph.protocol.network)
        make, W = (lambda **kw: _sched(graph, JScheduler, JBatcher, **kw),
                   jc["W"])
    else:
        graph, W = _graph(models)[0], tc["W"]
        fi = FaultInjector(network=_network(graph))
        make = lambda **kw: _sched(graph, **kw)        # noqa: E731
    fi.flap_replica(1, 0.05, 0.30)
    fi.flap_replica(2, 0.15, 0.45)
    fi.add_straggler(0, 0.0, 0.4, 3.0)
    sched = make(cloud_replicas=3, fault=fi)
    states = _run(sched, sched.add_stream, streams, {"W": W}, slo=0.5)
    assert sum(len(s.results) for s in states) == 18
    return fi.events, sched.chaos_stats, sched.router.healthy_count()


def test_flap_and_straggler_events_match_jax(models):
    jev, jstats, jhealthy = _chaos_events("jax", models)
    tev, tstats, thealthy = _chaos_events("port", models)
    assert len(tev) == len(jev) and jev
    for a, b in zip(jev, tev):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], float):
                np.testing.assert_allclose(b[k], a[k], rtol=LATENCY_RTOL,
                                           err_msg=k)
            else:
                assert a[k] == b[k], k
    for k in ("probes", "readmits", "requeues", "hedges"):
        assert tstats[k] == jstats[k], k
    assert tstats["readmits"] >= 1
    assert thealthy == jhealthy == 3
