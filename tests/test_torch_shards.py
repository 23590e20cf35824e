"""The port's claim-check store and sharded scheduler
(``repro_torch.serving.ingest``, ``repro_torch.serving.shards``).

The store holds tensor payloads (the fused hot path publishes the encoded
frames as a tensor), the JAX package's sharding gates of
``tests/test_shards.py`` hold in the port, and
``MultiStreamCoordinator(num_shards=2, use_store=True)`` gives the JAX
package's results and simulated-clock report on the same weights and
chunks.  32 x 32 models from the JAX package's inits, on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro.core.coordinator import MultiStreamCoordinator as JMulti
from repro.core.protocol import HighLowProtocol as JProtocol
from repro.models import classifier as jclf
from repro.models import detector as jdet
from repro_torch import weights
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.core.bandwidth import NetworkModel
from repro_torch.core.coordinator import MultiStreamCoordinator as TMulti
from repro_torch.core.protocol import HighLowProtocol
from repro_torch.serving.batching import CrossStreamBatcher
from repro_torch.serving.fault import FaultTolerantCoordinator
from repro_torch.serving.graph import GraphScheduler, VideoFunctionGraph
from repro_torch.serving.ingest import (ArtifactCorrupted, ArtifactStore,
                                        ClaimCheck, content_key)
from repro_torch.serving.shards import ShardedScheduler
from repro_torch.testing import (LATENCY_RTOL, MODEL_ATOL,
                                 conservation_errors, report_mismatches,
                                 results_mismatch)
from repro_torch.video import synthetic

torch.set_num_threads(1)

DET = DetectorConfig(name="shard-test-det", image_hw=(32, 32),
                     widths=(8, 16))
CLF = ClassifierConfig(name="shard-test-clf", crop_hw=(16, 16),
                       widths=(8, 16), feature_dim=16)
T_DET = tcfg.DetectorConfig(name="shard-test-det", image_hw=(32, 32),
                            widths=(8, 16))
T_CLF = tcfg.ClassifierConfig(name="shard-test-clf", crop_hw=(16, 16),
                              widths=(8, 16), feature_dim=16)


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
    td, tc = models[2], models[3]
    return VideoFunctionGraph(HighLowProtocol(T_DET, T_CLF, device="cpu"),
                              td, tc), tc


def _run(sched, add, streams, clf_params):
    states = [add(f"cam{i}", W=clf_params["W"]) for i in range(len(streams))]
    for st, chunks in zip(states, streams):
        for c in chunks:
            sched.submit(st, c, learn=False)
    sched.run_until_idle()
    return states


def _assert_same(sched_a, sched_b):
    for name in sched_a.streams:
        assert results_mismatch(sched_a.streams[name],
                                sched_b.streams[name]) is None, name


# ---------------------------------------------------------------------------
# the store holds tensors
# ---------------------------------------------------------------------------
def test_store_holds_tensor_payloads():
    store = ArtifactStore(integrity=True)
    frames = torch.arange(48, dtype=torch.float32).reshape(2, 2, 4, 3)
    ref = store.put(frames, key="k0", now=0.0)
    assert ref.shape == (2, 2, 4, 3) and ref.dtype == torch.float32
    assert ref.nbytes == frames.numel() * 4 == store.stats["bytes_current"]
    assert store.get(ref) is frames                # no copy on resolve
    ref2 = store.put(frames.clone(), key="k0", now=0.1)
    assert store.stats["dedup_hits"] == 1 and len(store) == 1
    assert store.stats["logical_bytes_current"] == 2 * ref.nbytes
    half = torch.zeros(3, dtype=torch.float16)
    assert store.put(half, key="k1").nbytes == 6

    store.corrupt("k0")
    bad = store._entries["k0"].payload
    assert bad is not frames                       # a copy, not in place
    assert torch.equal(frames, torch.arange(48, dtype=torch.float32
                                            ).reshape(2, 2, 4, 3))
    assert bad.dtype == frames.dtype and bad.device == frames.device
    assert bad.shape == frames.shape and not torch.equal(bad, frames)
    # the first 8 bytes flipped, the rest untouched
    assert torch.equal(bad.reshape(-1)[2:], frames.reshape(-1)[2:])
    with pytest.raises(ArtifactCorrupted):
        store.get(ref)
    assert store.stats["corruptions_detected"] == 1
    store.repair("k0", frames.clone())
    assert torch.equal(store.get(ref2), frames)
    for r in (ref, ref2):
        store.release(r, now=1.0)
    assert store.live_refs() == {"k1": 1}


def test_checksum_of_a_tensor_equals_its_numpy_bytes():
    from repro_torch.serving.ingest import _payload_checksum
    x = np.random.default_rng(0).random((3, 5), dtype=np.float32)
    assert _payload_checksum(torch.as_tensor(x)) == _payload_checksum(x) \
        == content_key(x)


@pytest.mark.parametrize("hot_path", ["fused", "sync"])
def test_scheduler_with_store_matches_storeless(models, hot_path):
    # the fused path publishes encoded frames as tensors: with the store on
    # it must run, and give the store-free scheduler's results bitwise
    graph, clf_params = _graph(models)
    streams = [_chunks(100 + i, 2) for i in range(3)]
    runs = []
    for store in (None, ArtifactStore(integrity=True)):
        s = GraphScheduler(
            graph, batcher=CrossStreamBatcher(max_chunks=3, window=0.05),
            hot_path=hot_path, store=store)
        _run(s, s.add_stream, streams, clf_params)
        s.drain()
        runs.append(s)
    _assert_same(*runs)
    srep = runs[1].throughput_report()["store"]
    assert srep["puts"] == 6 and srep["gets"] >= 6


# ---------------------------------------------------------------------------
# the JAX package's sharding gates (tests/test_shards.py), in the port
# ---------------------------------------------------------------------------
def test_one_shard_bitwise_identity(models):
    graph, clf_params = _graph(models)
    streams = [_chunks(300 + i, 3) for i in range(4)]
    plain = GraphScheduler(
        graph, batcher=CrossStreamBatcher(max_chunks=4, window=0.05),
        hot_path="fused")
    _run(plain, plain.add_stream, streams, clf_params)
    sharded = ShardedScheduler(
        graph, num_shards=1,
        batcher_factory=lambda i: CrossStreamBatcher(max_chunks=4,
                                                     window=0.05),
        hot_path="fused")
    _run(sharded, sharded.add_stream, streams, clf_params)
    _assert_same(plain, sharded)
    assert report_mismatches(plain.throughput_report(),
                             sharded.throughput_report()) == []
    srep = sharded.throughput_report()["store"]
    assert srep["puts"] == sum(len(s) for s in streams)
    assert srep["bytes_current"] <= srep["bytes_peak"]


@pytest.mark.parametrize("num_shards", [2, 3])
def test_k_shards_match_unsharded_oracle(models, num_shards):
    graph, clf_params = _graph(models)
    streams = [_chunks(400 + i, 3) for i in range(6)]
    oracle = GraphScheduler(
        graph, batcher=CrossStreamBatcher(max_chunks=1, window=0.0),
        hot_path="fused")
    _run(oracle, oracle.add_stream, streams, clf_params)
    sharded = ShardedScheduler(graph, num_shards=num_shards, steal=False,
                               hot_path="fused")
    _run(sharded, sharded.add_stream, streams, clf_params)
    _assert_same(oracle, sharded)
    assert report_mismatches(oracle.throughput_report(),
                             sharded.throughput_report(), peaks=False) == []
    sharded.drain()


def test_work_stealing_conserves_chunks_under_outage(models):
    graph, clf_params = _graph(models)
    shared = _chunks(500, 3)
    streams = {f"cam{i}": list(shared) for i in range(6)}
    fault = FaultTolerantCoordinator(NetworkModel())
    fault.fail_replica(1, at=0.15)
    sharded = ShardedScheduler(
        graph, num_shards=2,
        batcher_factory=lambda i: CrossStreamBatcher(max_chunks=2,
                                                     window=0.05),
        hot_path="fused", cloud_replicas=2, fault=fault)
    for name, chunks in streams.items():
        st = sharded.add_stream(name, W=clf_params["W"], shard=0)
        for c in chunks:
            sharded.submit(st, c, learn=False)
    sharded.drain()
    assert sharded.steals > 0
    assert any(e["event"] == "replica_failover" for e in fault.events)
    assert sharded.router.load_report()["healthy"] == 1
    assert conservation_errors(sharded.streams, streams) == []
    rep = sharded.throughput_report()
    assert rep["batch_stolen"] == rep["batch_adopted"] == sharded.steals
    for sh in sharded.shards:
        assert len(sh.batcher) == 0 and not sh._events


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_store_never_evicts_referenced_payload(kind):
    store = ArtifactStore(ttl=1.0)
    frames = np.arange(24, dtype=np.float32).reshape(2, 2, 2, 3)
    key = content_key(frames, "salt")
    wrap = (lambda a: a.copy()) if kind == "numpy" else torch.tensor

    ref1 = store.put(wrap(frames), key=key, now=0.0)
    ref2 = store.put(wrap(frames), key=key, now=0.1)
    assert isinstance(ref1, ClaimCheck) and ref1.key == ref2.key
    assert store.stats["dedup_hits"] == 1 and len(store) == 1
    assert store.stats["bytes_current"] == frames.nbytes
    assert store.stats["logical_bytes_current"] == 2 * frames.nbytes
    store.release(ref1, now=0.2)
    store.sweep(now=100.0)
    assert len(store) == 1
    np.testing.assert_array_equal(np.asarray(store.get(ref2)), frames)
    store.release(ref2, now=100.0)
    ref3 = store.put(wrap(frames), key=key, now=100.5)
    store.sweep(now=200.0)
    np.testing.assert_array_equal(np.asarray(store.get(ref3)), frames)
    store.release(ref3, now=200.0)
    store.sweep(now=200.5)
    assert len(store) == 1
    store.sweep(now=201.5)
    assert len(store) == 0 and store.stats["evictions"] == 1
    assert store.stats["bytes_current"] == 0
    with pytest.raises(KeyError):
        store.get(ref3)


def test_store_eviction_under_serving_load(models):
    graph, clf_params = _graph(models)
    base = _chunks(600, 2)
    streams = [[base[0], base[1], base[0], base[1]] for _ in range(2)]
    store = ArtifactStore(ttl=1e-6)
    sharded = ShardedScheduler(graph, num_shards=1, store=store,
                               hot_path="fused")
    _run(sharded, sharded.add_stream, streams, clf_params)
    for st in sharded.streams.values():
        assert len(st.results) == 4
    assert store.stats["evictions"] > 0
    store.sweep(now=float("inf"))
    assert len(store) == 0


def test_stream_thresholds_through_the_wrapper(models):
    # the override lands on the owning shard only, and the K = 2 run gives
    # the one-scheduler run with the same override bitwise
    graph, clf_params = _graph(models)
    streams = [_chunks(700 + i, 2) for i in range(3)]
    kw = dict(theta_cls=0.55, theta_loc=0.3)
    oracle = GraphScheduler(
        graph, batcher=CrossStreamBatcher(max_chunks=1, window=0.0),
        hot_path="fused")
    sharded = ShardedScheduler(graph, num_shards=2, steal=False,
                               hot_path="fused")
    for s in (oracle, sharded):
        states = [s.add_stream(f"cam{i}", W=clf_params["W"])
                  for i in range(3)]
        s.set_stream_thresholds("cam1", **kw)
        for st, chunks in zip(states, streams):
            for c in chunks:
                s.submit(st, c, learn=False)
        s.run_until_idle()
    owner = sharded._shard_of["cam1"]
    assert owner is sharded.shards[1]
    assert (owner.streams["cam1"].theta_cls,
            owner.streams["cam1"].theta_loc) == (0.55, 0.3)
    assert sharded.streams["cam0"].theta_cls is None
    _assert_same(oracle, sharded)


def test_hot_swap_through_the_wrapper_reaches_every_shard(models):
    graph, clf_params = _graph(models)
    sharded = ShardedScheduler(graph, num_shards=2, hot_path="fused")
    for i in range(4):
        sharded.add_stream(f"cam{i}", W=clf_params["W"])
    W = torch.full(tuple(clf_params["W"].shape), 0.5)
    assert sharded.hot_swap(W, version=2) == 0
    for st in sharded.streams.values():
        assert isinstance(st.W, np.ndarray)
        np.testing.assert_array_equal(st.W, W.numpy())
    sharded.hot_swap(torch.zeros_like(W), stream="cam3")
    assert not sharded.streams["cam3"].W.any()
    assert sharded.streams["cam2"].W.all()
    assert sharded.monitor.counters["hot_swaps"] == 2


# ---------------------------------------------------------------------------
# the port against the JAX package: K = 2 shards with the store on
# ---------------------------------------------------------------------------
def test_sharded_coordinator_matches_jax(models):
    jd, jc, td, tc = models
    streams = [_chunks(50 + i, 2) for i in range(6)]
    kw = dict(max_batch_chunks=2, batch_window=0.05, num_shards=2,
              use_store=True)
    jm = JMulti(JProtocol(DET, CLF), jd, jc, streams, **kw)
    tm = TMulti(HighLowProtocol(T_DET, T_CLF, device="cpu"), td, tc,
                streams, device="cpu", **kw)
    jres, tres = jm.run(learn=False), tm.run(learn=False)
    assert type(tm.scheduler).__name__ == "ShardedScheduler"
    assert len(tm.scheduler.shards) == 2
    assert jres.keys() == tres.keys()
    for name in jres:
        a, b = jres[name], tres[name]
        assert a.f1 == b.f1 and a.modes == b.modes, name
        np.testing.assert_allclose(b.latencies, a.latencies,
                                   rtol=LATENCY_RTOL)
        np.testing.assert_allclose(b.bandwidth, a.bandwidth,
                                   rtol=LATENCY_RTOL)
        for (c1, r1, m1), (c2, r2, m2) in zip(
                jm.scheduler.streams[name].results,
                tm.scheduler.streams[name].results):
            assert c1 is c2 and m1 == m2
            np.testing.assert_array_equal(r2.labels, r1.labels)
            np.testing.assert_array_equal(r2.valid, r1.valid)
            np.testing.assert_allclose(r2.boxes, r1.boxes, atol=MODEL_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(r2.fog_scores, r1.fog_scores,
                                       atol=MODEL_ATOL, rtol=0)
    jr, tr = jm.report(), tm.report()
    # the simulated-clock report: counters equal, simulated times within
    # LATENCY_RTOL (they follow the codec's byte counts).  The bundle byte
    # gauges count the device buffers a flush keeps, which are each
    # package's own (the unsharded runs differ there too)
    sim = {"detect_span_s", "sim_frames_per_s", "detect_occupancy",
           "fog_batch_occupancy", "slo_attainment"}
    ignore = {"store", "hot_bundle_bytes", "hot_bundle_bytes_peak"} | sim
    assert report_mismatches(jr, tr, ignore=ignore) == []
    for k in sim & set(jr):
        np.testing.assert_allclose(tr[k], jr[k], rtol=LATENCY_RTOL,
                                   err_msg=k)
    assert tr["shards"] == 2 and tr["steals"] == jr["steals"]
    for k in ("puts", "unique_puts", "dedup_hits", "gets", "releases",
              "evictions", "bytes_peak", "logical_bytes_peak"):
        assert tr["store"][k] == jr["store"][k], k
    assert tm.scheduler.store.live_refs() == {}
