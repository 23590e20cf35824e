"""The port's serving path end to end: the multi-stream workload of
``tests/test_hot_path.py`` through the JAX package and the port on both hot
paths, and the ``repro_torch.launch.serve`` entry point."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro.core.coordinator import MultiStreamCoordinator as JMulti
from repro.core.protocol import HighLowProtocol as JProtocol
from repro.models import classifier as jclf
from repro.models import detector as jdet
from repro.video import synthetic
from repro_torch import weights
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.core.coordinator import MultiStreamCoordinator as TMulti
from repro_torch.core.protocol import HighLowProtocol as TProtocol
from repro_torch.kernels import ops
from repro_torch.testing import LATENCY_RTOL, MODEL_ATOL

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DET = DetectorConfig(name="hotpath-test-det", image_hw=(32, 32),
                     widths=(8, 16))
CLF = ClassifierConfig(name="hotpath-test-clf", crop_hw=(16, 16),
                       widths=(8, 16), feature_dim=16)
T_DET = tcfg.DetectorConfig(name="hotpath-test-det", image_hw=(32, 32),
                            widths=(8, 16))
T_CLF = tcfg.ClassifierConfig(name="hotpath-test-clf", crop_hw=(16, 16),
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


@pytest.fixture(scope="module")
def runs(models):
    """The tests/test_hot_path.py:46 workload (4 streams x 2 chunks) through
    both packages on both hot paths."""
    jd, jc, td, tc = models
    streams = [_chunks(50 + i, 2) for i in range(4)]
    out = {}
    for mode in ("sync", "fused"):
        jm = JMulti(JProtocol(DET, CLF), jd, jc, streams, max_batch_chunks=4,
                    batch_window=0.05, hot_path=mode)
        tm = TMulti(TProtocol(T_DET, T_CLF, device="cpu"), td, tc, streams,
                    max_batch_chunks=4, batch_window=0.05, hot_path=mode,
                    device="cpu")
        out[mode] = ((jm.run(learn=False), jm), (tm.run(learn=False), tm))
    return out


@pytest.mark.parametrize("mode", ["sync", "fused"])
def test_multi_stream_matches_jax(runs, mode):
    (jres, jm), (tres, tm) = runs[mode]
    assert jres.keys() == tres.keys()
    for name in jres:
        a, b = jres[name], tres[name]
        assert a.f1 == b.f1, name
        np.testing.assert_allclose(b.bandwidth, a.bandwidth,
                                   rtol=LATENCY_RTOL)
        np.testing.assert_allclose(b.latencies, a.latencies,
                                   rtol=LATENCY_RTOL)
        assert a.modes == b.modes
        st_j, st_t = jm.scheduler.streams[name], tm.scheduler.streams[name]
        for (_, r1, _), (_, r2, _) in zip(st_j.results, st_t.results):
            np.testing.assert_allclose(r2.fog_scores, r1.fog_scores,
                                       atol=MODEL_ATOL, rtol=0)
            np.testing.assert_allclose(r2.boxes, r1.boxes, atol=MODEL_ATOL,
                                       rtol=0)
            assert r1.coord_bytes == r2.coord_bytes
    jr, tr = jm.report(), tm.report()
    for k in ("calls", "frames", "padded_frames", "hot_flushes",
              "hot_crops_classified", "hot_crops_budget", "w_uploads"):
        assert jr[k] == tr[k], k


def test_fused_keeps_one_host_sync_per_flush(runs):
    _, (_, tm) = runs["fused"]
    hps = tm.scheduler.hot_path_stats
    assert hps["flushes"] > 0
    assert hps["host_syncs"] == hps["flushes"]
    assert hps["result_downloads"] == hps["flushes"]
    assert hps["crops_classified"] < hps["crops_budget"]


def test_fused_matches_sync_within_port(runs):
    _, (fres, fm) = runs["fused"]
    _, (sres, sm) = runs["sync"]
    for name in fres:
        assert fres[name].f1 == sres[name].f1
        assert fres[name].latencies == sres[name].latencies
        for (_, r1, _), (_, r2, _) in zip(fm.scheduler.streams[name].results,
                                          sm.scheduler.streams[name].results):
            np.testing.assert_array_equal(r1.prop_valid, r2.prop_valid)
            np.testing.assert_allclose(r1.fog_scores, r2.fog_scores,
                                       atol=MODEL_ATOL, rtol=0)


def test_fused_flush_of_64_streams_matches_jax(models, monkeypatch):
    # one flush packs a chunk of each of 64 streams, and every stream keeps
    # its own readout: the compacted classify stacks G = 64 readouts
    jd, jc, td, tc = models
    streams = [_chunks(200 + i, 1) for i in range(64)]
    stacked = []
    readout = ops.onevsall_scores

    def spy(x, ws, widx=None):
        stacked.append(ws.shape[0])
        return readout(x, ws, widx)

    monkeypatch.setattr(ops, "onevsall_scores", spy)
    kw = dict(max_batch_chunks=64, batch_window=0.05, hot_path="fused")
    jm = JMulti(JProtocol(DET, CLF), jd, jc, streams, **kw)
    tm = TMulti(TProtocol(T_DET, T_CLF, device="cpu"), td, tc, streams,
                device="cpu", **kw)
    jres, tres = jm.run(learn=False), tm.run(learn=False)
    assert tm.scheduler.hot_path_stats["flushes"] == 1
    assert stacked == [64]
    for name in jres:
        assert jres[name].f1 == tres[name].f1, name
        (_, r1, _), = jm.scheduler.streams[name].results
        (_, r2, _), = tm.scheduler.streams[name].results
        np.testing.assert_array_equal(r2.prop_valid, r1.prop_valid)
        np.testing.assert_allclose(r2.fog_scores, r1.fog_scores,
                                   atol=MODEL_ATOL, rtol=0)


def test_cpu_run_launches_no_kernel(models):
    _, _, td, tc = models
    ops.reset_launch_counts()
    TMulti(TProtocol(T_DET, T_CLF, device="cpu"), td, tc, [_chunks(3, 1)],
           device="cpu").run(learn=False)
    assert ops.launch_counts() == {name: 0 for name in [*ops.KERNELS,
                                                        *ops.VJPS]}


def test_cuda_entry_points_raise_without_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TProtocol(T_DET, T_CLF)               # device="cuda" by default
    with pytest.raises(ValueError, match="device"):
        TMulti(TProtocol(T_DET, T_CLF, device="cpu"), models[2], models[3],
               [_chunks(3, 1)])               # coordinator defaults to cuda


def test_serve_entry_point_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--video-streams",
         "2", "--video-chunks", "1", "--video-frames", "2", "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "video graph: 2 streams, 2 chunks" in proc.stdout
    assert "hot path: fused — 1.0 host syncs/flush" in proc.stdout
