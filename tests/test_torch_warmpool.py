"""The port's warm-pool plane (``repro_torch.serving.autoscaler``) through
the sharded scheduler: with the policy disabled the serving plane is
bitwise the policy-free scheduler at 1 and 2 shards (the JAX package's
``tests/test_warmpool.py`` gate), with the claim-check store off and on;
and an enabled policy's warm counters equal the JAX package's on the same
bursts.  32 x 32 models from the JAX package's inits, on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro.core.protocol import HighLowProtocol as JProtocol
from repro.models import classifier as jclf
from repro.models import detector as jdet
from repro.serving.autoscaler import CostAwareAutoscaler as JAutoscaler
from repro.serving.autoscaler import WarmPoolPolicy as JWarmPoolPolicy
from repro.serving.batching import CrossStreamBatcher as JBatcher
from repro.serving.graph import VideoFunctionGraph as JGraph
from repro.serving.shards import ShardedScheduler as JSharded
from repro_torch import weights
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.core.protocol import HighLowProtocol
from repro_torch.serving.autoscaler import (CostAwareAutoscaler,
                                            WarmPoolPolicy)
from repro_torch.serving.batching import CrossStreamBatcher
from repro_torch.serving.graph import VideoFunctionGraph
from repro_torch.serving.shards import ShardedScheduler
from repro_torch.testing import report_mismatches, results_mismatch
from repro_torch.video import synthetic

torch.set_num_threads(1)

DET = DetectorConfig(name="warmpool-test-det", image_hw=(32, 32),
                     widths=(8, 16))
CLF = ClassifierConfig(name="warmpool-test-clf", crop_hw=(16, 16),
                       widths=(8, 16), feature_dim=16)
T_DET = tcfg.DetectorConfig(name="warmpool-test-det", image_hw=(32, 32),
                            widths=(8, 16))
T_CLF = tcfg.ClassifierConfig(name="warmpool-test-clf", crop_hw=(16, 16),
                              widths=(8, 16), feature_dim=16)
PERIOD_S = 8.0


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


def _warm_policy(cls=WarmPoolPolicy, **kw):
    kw.setdefault("cold_start_s", 0.6)
    kw.setdefault("frame_service_s", 0.05)
    kw.setdefault("slo_slack_s", 0.5)
    kw.setdefault("max_replicas", 4)
    return cls(**kw)


@pytest.mark.parametrize("use_store", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_disabled_policy_is_bitwise_identical(models, num_shards,
                                              use_store):
    td, tc = models[2], models[3]
    graph = VideoFunctionGraph(HighLowProtocol(T_DET, T_CLF, device="cpu"),
                               td, tc)
    streams = [_chunks(i, 3) for i in range(4)]

    def run(warm_pool):
        sched = ShardedScheduler(
            graph, num_shards=num_shards,
            batcher_factory=lambda i: CrossStreamBatcher(max_chunks=8,
                                                         window=0.05),
            use_store=use_store, hot_path="fused", cloud_replicas=2,
            warm_pool=warm_pool)
        states = [sched.add_stream(f"cam{i}", W=tc["W"], slo=5.0)
                  for i in range(4)]
        for st, cs in zip(states, streams):
            for c in cs:
                sched.submit(st, c, learn=False)
        sched.drain()
        return sched, sched.throughput_report()

    plain, rep_plain = run(None)
    off, rep_off = run(_warm_policy(enabled=False))
    for name in plain.streams:
        assert results_mismatch(plain.streams[name],
                                off.streams[name]) is None, name
    assert report_mismatches(rep_plain, rep_off) == []
    assert rep_off["warm_replicas_prewarmed"] == 0
    assert rep_off["warm_prewarm_events"] == 0


def _drive_bursts(sched, states, bursts=5):
    per = [_chunks(i, bursts, frames=4) for i in range(len(states))]
    for b in range(bursts):
        for st in states:
            st.clock = max(st.clock, b * PERIOD_S)
        for st, cs in zip(states, per):
            sched.submit(st, cs[b], learn=False)
        limit = (b + 1) * PERIOD_S
        while True:
            sh = sched._next_shard()
            if sh is None or sh._peek_key()[0] >= limit:
                break
            sched.step()
    sched.run_until_idle()


def _warm_run(pkg, models):
    jd, jc, td, tc = models
    if pkg == "jax":
        graph, W = JGraph(JProtocol(DET, CLF), jd, jc), jc["W"]
        cls, asc_cls, batcher, sharded = (JWarmPoolPolicy, JAutoscaler,
                                          JBatcher, JSharded)
    else:
        graph = VideoFunctionGraph(
            HighLowProtocol(T_DET, T_CLF, device="cpu"), td, tc)
        W = tc["W"]
        cls, asc_cls, batcher, sharded = (WarmPoolPolicy,
                                          CostAwareAutoscaler,
                                          CrossStreamBatcher,
                                          ShardedScheduler)
    pol = _warm_policy(cls)
    asc = asc_cls(min_devices=1, max_devices=4, unit="replicas",
                  cold_start_s=0.6, warm_pool=pol)
    sched = sharded(graph, num_shards=2, hot_path="fused",
                    batcher_factory=lambda i: batcher(max_chunks=8,
                                                      window=0.05),
                    cloud_replicas=1, autoscaler=asc, scale_unit="replicas",
                    cold_start_s=0.6, warm_pool=pol)
    states = [sched.add_stream(f"cam{i}", W=W, slo=5.0) for i in range(6)]
    _drive_bursts(sched, states)
    return sched.throughput_report()


def test_enabled_policy_matches_jax_sharded(models):
    jr, tr = _warm_run("jax", models), _warm_run("port", models)
    warm = sorted(k for k in jr if k.startswith("warm_"))
    assert warm and warm == sorted(k for k in tr if k.startswith("warm_"))
    for k in warm:
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4, err_msg=k)
    assert tr["warm_prewarm_events"] > 0
    assert tr["sched_finalizes"] == jr["sched_finalizes"] == 30
