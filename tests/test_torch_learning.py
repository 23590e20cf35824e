"""The port's incremental learner and continual-learning plane against the
JAX package: the K5 update's plain version (and the Pallas kernel in
interpret mode), the §V update rules and Eq. 9 ensemble, the learning
modules' own unit tests run on the port's modules, and the plane end to end
on the reduced 32x32 configs of ``tests/test_learning.py``, with the same
numpy inputs and the same weights on both sides."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro.core import incremental as jinc
from repro.core.coordinator import MultiStreamCoordinator as JMulti
from repro.core.hitl import OracleAnnotator as JAnnotator
from repro.core.protocol import HighLowProtocol as JProtocol
from repro.kernels import onevsall as jova
from repro.learning import ContinualLearningPlane as JPlane
from repro.learning import LearningConfig as JLearningConfig
from repro.models import classifier as jclf
from repro.models import detector as jdet
from repro.video import synthetic
from repro_torch import weights
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.core import incremental as tinc
from repro_torch.core.coordinator import MultiStreamCoordinator, StreamSpec
from repro_torch.core.hitl import BACKGROUND, UNLABELED, OracleAnnotator
from repro_torch.core.protocol import HighLowProtocol
from repro_torch.kernels import ops
from repro_torch.kernels import onevsall_update as ou
from repro_torch.learning import (BackgroundTrainer, ContinualLearningPlane,
                                  DriftConfig, DriftDetector, HealthPosterior,
                                  LabelCandidate, LabelingQueue,
                                  LearningConfig, PromotionGate, ReplayBuffer,
                                  ShadowEvaluator)
from repro_torch.serving.registry import ModelZoo
from repro_torch.testing import (LEARN_RTOL, OMEGA_RTOL, UPDATE_ETA,
                                 UPDATE_RTOL, open_episode, rel_err,
                                 update_case)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DET = DetectorConfig(name="learn-test-det", image_hw=(32, 32),
                     widths=(8, 16))
CLF = ClassifierConfig(name="learn-test-clf", crop_hw=(16, 16),
                       widths=(8, 16), feature_dim=16)
T_DET = tcfg.DetectorConfig(name="learn-test-det", image_hw=(32, 32),
                            widths=(8, 16))
T_CLF = tcfg.ClassifierConfig(name="learn-test-clf", crop_hw=(16, 16),
                              widths=(8, 16), feature_dim=16)


@pytest.fixture(scope="module")
def models():
    jd = jdet.init_detector(DET, jax.random.PRNGKey(0))
    jc = jclf.init_classifier(CLF, jax.random.PRNGKey(1))
    return (jd, jc, weights.from_numpy_tree(jd, "cpu"),
            weights.from_numpy_tree(jc, "cpu"))


def _chunks(seed, n, frames=2, drift=0.0):
    rng = np.random.default_rng(seed)
    return [synthetic.drifted_chunk(rng, "traffic", drift=drift,
                                    num_frames=frames, hw=(32, 32))
            for _ in range(n)]


def _features(n, seed=0, d=8, c=4):
    """Clustered, learnable features with the bias-absorbing 1."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(c, d)) * 2.0
    labels = rng.integers(0, c, n)
    xs = centers[labels] + rng.normal(0, 0.3, (n, d))
    xs = np.concatenate([xs, np.ones((n, 1))], -1).astype(np.float32)
    return xs, labels


def _onehot(labels, c):
    return np.eye(c, dtype=np.float32)[labels]


def _multi(models, side, streams, plane, **kw):
    jd, jc, td, tc = models
    if side == "jax":
        return JMulti(JProtocol(DET, CLF), jd, jc, streams,
                      learning_plane=plane, **kw)
    return MultiStreamCoordinator(HighLowProtocol(T_DET, T_CLF, device="cpu"),
                                  td, tc, streams, learning_plane=plane,
                                  device="cpu", **kw)


# ---------------------------------------------------------------------------
# K5: the plain version against the JAX reference and the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,d1,c", [(64, 129, 8), (100, 65, 4), (1, 129, 8)])
def test_onevsall_update_plain_matches_jax_and_pallas(b, d1, c):
    x, y, w = update_case(b, d1, c)
    got = ou.onevsall_update_ref(*map(torch.as_tensor, (x, y, w)),
                                 eta=UPDATE_ETA).numpy()
    want = jova.onevsall_update_ref(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(w), eta=UPDATE_ETA)
    pallas = jova.onevsall_update(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(w), eta=UPDATE_ETA, bb=32,
                                  interpret=True)
    assert rel_err(got, want) <= UPDATE_RTOL
    assert rel_err(got, pallas) <= UPDATE_RTOL


def test_onevsall_update_dispatch_runs_plain_on_cpu():
    x, y, w = map(torch.as_tensor, update_case(4, 17, 10))
    ops.reset_launch_counts()
    got = ops.onevsall_update(x, y, w, eta=UPDATE_ETA)
    assert torch.equal(got, ou.onevsall_update_ref(x, y, w, eta=UPDATE_ETA))
    assert ops.launch_counts()["onevsall_update"] == 0
    assert "onevsall_update" in ops.KERNELS


# ---------------------------------------------------------------------------
# §V update rules, the sequential replay, and the Eq. 9 ensemble
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rule", ["eq8", "proximal"])
def test_single_instance_updates_match_jax(rule):
    xs, labels = _features(8, seed=1)
    ys = _onehot(labels, 4)
    W = np.random.default_rng(2).normal(0, 0.3, (9, 4)).astype(np.float32)
    jfn = {"eq8": jinc.update_eq8, "proximal": jinc.update_proximal}[rule]
    tfn = {"eq8": tinc.update_eq8, "proximal": tinc.update_proximal}[rule]
    for i in range(len(xs)):
        want = jfn(jnp.asarray(W), jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                   0.3)
        got = tfn(torch.as_tensor(W), torch.as_tensor(xs[i]),
                  torch.as_tensor(ys[i]), 0.3)
        assert rel_err(got.numpy(), want) <= UPDATE_RTOL


@pytest.mark.parametrize("rule,passes,n,d", [
    ("proximal", 1, 256, 8), ("proximal", 2, 256, 8), ("eq8", 1, 256, 8),
    ("eq8", 2, 256, 8),
    ("proximal", 2, 2048, 128)])      # the trainer's max_buffer, full d+1
def test_batch_update_matches_jax(rule, passes, n, d):
    xs, labels = _features(n, seed=3, d=d, c=8)
    if d > 8:
        xs[:, :-1] /= np.sqrt(d)       # keep the step eta |x|^2 moderate
    ys = _onehot(labels, 8)
    W0 = np.zeros((d + 1, 8), np.float32)
    eta = 0.3 if rule == "proximal" else 0.05
    want = jinc.batch_update(jnp.asarray(W0), jnp.asarray(xs),
                             jnp.asarray(ys), rule=rule, eta=eta,
                             passes=passes)
    got = tinc.batch_update(torch.as_tensor(W0), xs, ys, rule=rule, eta=eta,
                            passes=passes)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= LEARN_RTOL


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_onevsall_replay_plain_matches_jax_batch_update(passes):
    # K5's replay's plain version (the loop of one-row plain steps) against
    # the reference's proximal scan, at the learner's d+1 = 129, C = 8
    xs, labels = _features(96, seed=7, d=128, c=8)
    xs[:, :-1] /= np.sqrt(128)
    ys = _onehot(labels, 8)
    W0 = np.random.default_rng(8).normal(0, 0.1, (129, 8)).astype(np.float32)
    want = jinc.batch_update(jnp.asarray(W0), jnp.asarray(xs),
                             jnp.asarray(ys), rule="proximal", eta=UPDATE_ETA,
                             passes=passes)
    got = ou.onevsall_replay_ref(*map(torch.as_tensor, (xs, ys, W0)),
                                 eta=UPDATE_ETA, passes=passes)
    assert rel_err(got.numpy(), want) <= LEARN_RTOL
    assert torch.equal(ops.onevsall_replay(*map(torch.as_tensor,
                                                (xs, ys, W0)),
                                           eta=UPDATE_ETA, passes=passes),
                       got)


def test_batch_update_takes_one_k5_step_per_instance_per_pass(monkeypatch):
    # the reference's sequential scan: never one batched K5 call
    calls = []
    real = ops.onevsall_update

    def spy(x, y, w, *, eta):
        calls.append(tuple(x.shape))
        return real(x, y, w, eta=eta)

    monkeypatch.setattr(ops, "onevsall_update", spy)
    xs, labels = _features(37, seed=4)
    tinc.batch_update(torch.zeros(9, 4), xs, _onehot(labels, 4),
                      rule="proximal", eta=0.3, passes=3)
    assert calls == [(1, 9)] * (37 * 3)
    calls.clear()
    tinc.batch_update(torch.zeros(9, 4), xs, _onehot(labels, 4), rule="eq8")
    assert calls == []                 # Eq. 8 has no kernel


def test_ensemble_functions_match_jax():
    xs, labels = _features(300, seed=5)
    ys = _onehot(labels, 4)
    rng = np.random.default_rng(6)
    snaps = rng.normal(0, 0.5, (4, 9, 4)).astype(np.float32)
    omega_j = np.array(jinc.ensemble_weights(jnp.asarray(snaps),
                                               jnp.asarray(xs),
                                               jnp.asarray(ys)))
    omega_t = tinc.ensemble_weights(torch.as_tensor(snaps), xs, ys).numpy()
    assert rel_err(omega_t, omega_j) <= LEARN_RTOL
    pred_j = jinc.ensemble_predict(jnp.asarray(snaps), jnp.asarray(omega_j),
                                   jnp.asarray(xs))
    pred_t = tinc.ensemble_predict(snaps, omega_j, xs).numpy()
    assert rel_err(pred_t, pred_j) <= UPDATE_RTOL
    omega = np.array([1.0, 5e-4, -0.3, 1e-6], np.float32)
    for a, b in zip(tinc.prune_ensemble(snaps, omega),
                    jinc.prune_ensemble(snaps, omega)):
        np.testing.assert_array_equal(a, b)
    for W in snaps:
        assert tinc.eval_accuracy(W, xs, labels) == jinc.eval_accuracy(
            W, xs, labels)
    assert tinc.eval_accuracy(snaps[0], xs[:0], labels[:0]) == 0.0
    assert tinc.ensemble_accuracy(snaps, omega_j, xs, labels) == \
        jinc.ensemble_accuracy(snaps, omega_j, xs, labels)


def test_accuracy_rounds_like_the_reference_mean():
    # the reference's mean is the count times float32(1/n), which differs
    # from a float32 division in the last bit for many (hits, n)
    rng = np.random.default_rng(7)
    for n in (3, 7, 10, 37, 255):
        xs = rng.normal(size=(n, 3)).astype(np.float32)
        W = rng.normal(size=(3, 2)).astype(np.float32)
        for k in range(n + 1):
            labels = (xs @ W).argmax(-1)
            labels[k:] = 1 - labels[k:]
            assert tinc.eval_accuracy(W, xs, labels) == \
                jinc.eval_accuracy(W, xs, labels)


def test_incremental_learner_matches_jax():
    xs, labels = _features(100, seed=8)
    W0 = np.zeros((9, 4), np.float32)
    learners = (jinc.IncrementalLearner(num_classes=4, trigger=16,
                                        budget=70),
                tinc.IncrementalLearner(num_classes=4, trigger=16,
                                        budget=70))
    Ws = [jnp.asarray(W0), torch.as_tensor(W0)]
    flags = ([], [])
    for x, lab in zip(xs, labels):
        for k, ln in enumerate(learners):
            ln.collect(x, int(lab))
            Ws[k], upd = ln.maybe_update(Ws[k])
            flags[k].append(upd)
    jl, tl = learners
    assert flags[0] == flags[1] and sum(flags[1]) == 5   # 4 x 16 + the rest
    assert (tl.labels_used, tl.updates_done) == (jl.labels_used,
                                                 jl.updates_done)
    assert tl.budget_exhausted and tl.buffered == 0
    for a, b in zip(tl.snapshots, jl.snapshots):
        assert rel_err(a, b) <= LEARN_RTOL
    # the snapshots of one trajectory are nearly collinear: the ridge
    # solve is ill-conditioned, its consequences are not
    assert rel_err(tl.fit_ensemble(), jl.fit_ensemble()) <= OMEGA_RTOL
    got = tl.predict(torch.as_tensor(xs)).numpy()
    want = np.asarray(jl.predict(jnp.asarray(xs)))
    assert rel_err(got, want) <= OMEGA_RTOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# The JAX package's learning unit tests, run on the port's modules
# (tests/test_learning.py:114-300, tests/test_per_site.py:262-375)
# ---------------------------------------------------------------------------
def test_drift_detector_quiet_on_noisy_stationary_stream():
    rng = np.random.default_rng(3)
    det = DriftDetector(DriftConfig(window=6, warmup=4, threshold=0.3,
                                    patience=2, cooldown=4))
    for t in range(200):
        assert det.observe("cam0", 0.7 + rng.normal(0.0, 0.05), t) is None
    assert det.events == []


def test_drift_detector_debounces_noisy_drop():
    rng = np.random.default_rng(4)
    det = DriftDetector(DriftConfig(window=4, warmup=4, threshold=0.3,
                                    patience=2, cooldown=6))
    series = [0.8] * 8 + [0.3] * 30
    times = [t for t, v in enumerate(series)
             if det.observe("cam0", v + rng.normal(0.0, 0.03), t)
             is not None]
    assert times and all(b - a > 6 for a, b in zip(times, times[1:]))
    ev = det.events[0]
    assert ev.severity > 0.3 and 8 <= ev.onset_t <= ev.t


def test_drift_detector_rebaseline_resets_reference():
    det = DriftDetector(DriftConfig(window=4, warmup=2, threshold=0.2,
                                    patience=1, cooldown=2))
    for t in range(6):
        det.observe("s", 0.8, t)
    for t in range(6, 12):
        det.observe("s", 0.4, t)
    assert det.events
    det.rebaseline("s")
    assert det.baseline("s") == pytest.approx(det.ewma("s"))
    assert det.recovered("s")
    n = len(det.events)
    for t in range(12, 18):
        det.observe("s", 0.4, t)
    assert len(det.events) == n


def test_oracle_charges_only_issued_labels():
    gt_b = np.array([[0.1, 0.1, 0.5, 0.5]])
    gt_l = np.array([2])
    boxes = np.tile(gt_b, (5, 1))
    ann = OracleAnnotator(budget=3)
    assert list(ann.label_regions(boxes, gt_b, gt_l)) == [
        2, 2, 2, UNLABELED, UNLABELED]
    assert ann.labels_provided == 3 and ann.remaining == 0
    assert all(lab == UNLABELED for lab in ann.label_regions(boxes, gt_b,
                                                             gt_l))
    ann2 = OracleAnnotator(budget=2)
    far = np.array([[0.8, 0.8, 0.9, 0.9]])
    assert ann2.label_regions(far, gt_b, gt_l)[0] == BACKGROUND
    assert ann2.labels_provided == 1


def test_labeling_queue_most_uncertain_first():
    gt_b = np.array([[0.1, 0.1, 0.5, 0.5]])
    gt_l = np.array([1])
    q = LabelingQueue(max_size=3)
    for margin in (0.8, 0.1, 0.4, 0.6):
        q.push(LabelCandidate(features=np.ones(3), box=gt_b[0],
                              scores=np.array([0.9, 0.9 - margin]),
                              gt_boxes=gt_b, gt_labels=gt_l))
    assert len(q) == 3
    ann = OracleAnnotator()
    uncs = [i.candidate.uncertainty for i in q.issue(ann, 10)]
    assert uncs == sorted(uncs, reverse=True)
    assert uncs[0] == pytest.approx(0.9)
    assert ann.labels_provided == 3
    assert q.stats["issued"] == 3 and q.stats["dropped"] == 1


def test_labeling_queue_stops_at_budget():
    gt_b = np.array([[0.1, 0.1, 0.5, 0.5]])
    gt_l = np.array([1])
    q = LabelingQueue()
    for _ in range(6):
        q.push(LabelCandidate(features=np.ones(3), box=gt_b[0],
                              scores=np.array([0.6, 0.5]),
                              gt_boxes=gt_b, gt_labels=gt_l))
    ann = OracleAnnotator(budget=2)
    assert len(q.issue(ann, 6)) == 2 and ann.labels_provided == 2
    assert len(q) == 4


def test_trainer_registers_versions_with_lineage():
    xs, labels = _features(80, seed=7)
    zoo = ModelZoo()
    W0 = np.zeros((xs.shape[1], 4), np.float32)
    zoo.register("fog-classifier", {"W": W0})
    tr = BackgroundTrainer(zoo, num_classes=4, min_batch=16, eta=0.5,
                           device="cpu")
    assert tr.maybe_train(W0) is None
    for i in range(40):
        tr.add_labeled(xs[i], int(labels[i]), t=float(i))
    rec = tr.maybe_train(W0, t=40.0, parent_version=1)
    assert rec is not None and rec.version == 2
    assert isinstance(rec.params["W"], np.ndarray)      # host copy in zoo
    assert rec.lineage["parent_version"] == 1
    assert rec.lineage["data_span"] == (0.0, 39.0)
    assert rec.lineage["labels"] == 40
    assert zoo.get("fog-classifier").version == 1
    assert tr.snapshots and tr.snapshot_versions == [2]
    assert tinc.eval_accuracy(rec.params["W"], xs, labels) > 0.8
    for i in range(40, 60):
        tr.add_labeled(xs[i], int(labels[i]), t=float(i))
    rec2 = tr.maybe_train(rec.params["W"], t=60.0, parent_version=2)
    assert rec2.lineage["labels"] == 20 and rec2.lineage["replayed"] == 60
    assert tr.drop_older_than(50.0) == 50 and tr.buffered == 10


def test_trainer_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        BackgroundTrainer(ModelZoo(), num_classes=4)


def test_promotion_gate_and_rollback_restore_bits():
    xs, labels = _features(120, seed=9)
    zoo = ModelZoo()
    W_good = np.zeros((xs.shape[1], 4), np.float32)
    for x, lab in zip(xs, labels):
        W_good[:, lab] += 0.1 * x
    W_bad = -W_good
    zoo.register("fog-classifier", {"W": W_bad})
    ev = ShadowEvaluator(ReplayBuffer())
    gate = PromotionGate(ev, min_holdout=8, min_gain=0.05,
                         rollback_margin=0.2)
    assert not gate.evaluate(W_bad, W_good)["promote"]
    for x, lab in zip(xs[:40], labels[:40]):
        ev.holdout.add(x, int(lab), t=0.0)
    dec = gate.evaluate(W_bad, W_good)
    assert dec["promote"] and dec["cand_score"] > dec["live_score"]
    assert not gate.evaluate(W_good, W_good)["promote"]
    rec = zoo.register_version("fog-classifier", {"W": W_good},
                               lineage={"parent_version": 1})
    zoo.promote("fog-classifier", rec.version)
    gate.note_promotion(dec["cand_score"])
    assert not gate.should_rollback(W_good, W_bad)[0]
    do, score = gate.should_rollback(W_bad, W_good)
    assert do and score < gate.promoted_score
    back = zoo.rollback("fog-classifier")
    gate.note_rollback()
    np.testing.assert_array_equal(back.params["W"], W_bad)
    assert gate.rollbacks == 1


class _SwapAt:
    """Test plane stub: hot-swaps a fixed W at the k-th finalized chunk."""

    def __init__(self, W, at):
        self.W, self.at, self.seen, self.inflight = W, at, 0, None

    def on_chunk(self, scheduler, stream, chunk, res, t, mode):
        self.seen += 1
        if self.seen == self.at:
            self.inflight = scheduler.hot_swap(self.W, version=99, t=t)


def test_hot_swap_mid_run_conserves_chunks(models):
    streams = [_chunks(1000 + i, 3) for i in range(4)]
    multi = _multi(models, "torch", streams, None, max_batch_chunks=4,
                   batch_window=0.05)
    W_new = models[3]["W"].numpy() + 0.25
    stub = _SwapAt(W_new, at=2)
    multi.scheduler.plane = stub
    mout = multi.run(learn=True)
    assert stub.inflight is not None
    seen = set()
    for i, chunks in enumerate(streams):
        st = multi.scheduler.streams[f"cam{i}"]
        assert [id(c) for c, _, _ in st.results] == [id(c) for c in chunks]
        seen.update(id(c) for c, _, _ in st.results)
        assert len(mout[f"cam{i}"].latencies) == len(chunks)
        np.testing.assert_array_equal(st.W, W_new)
    assert len(seen) == sum(len(c) for c in streams)
    swaps = multi.scheduler.monitor.events_of("hot_swap")
    assert len(swaps) == 1 and swaps[0]["version"] == 99


def test_plane_attaches_and_collects_under_budget(models):
    plane = ContinualLearningPlane(
        T_CLF.num_classes,
        LearningConfig(label_budget=32, labels_per_round=8,
                       sentinel_per_chunk=1, min_batch=2, min_holdout=2),
        annotator=OracleAnnotator(iou_threshold=0.0, budget=32))
    streams = [_chunks(1100 + i, 3) for i in range(2)]
    multi = _multi(models, "torch", streams, plane, max_batch_chunks=2,
                   batch_window=0.05)
    assert plane.device == torch.device("cpu")       # the scheduler's
    assert plane.trainer.device == torch.device("cpu")
    plane.state = "adapt"
    multi.run(learn=True)
    s = plane.summary()
    assert 0 < s["labels_charged"] <= 32
    assert s["trainer"]["rounds"] >= 1
    zoo = multi.scheduler.graph.zoo
    assert len(zoo.versions("fog-classifier")) >= 2
    cand = zoo.get_version("fog-classifier",
                           zoo.versions("fog-classifier")[-1])
    assert "parent_version" in cand.lineage and "data_span" in cand.lineage
    assert multi.report()["learning"]["state"] in ("adapt", "exhausted",
                                                   "monitor")


def test_per_site_plane_isolates_lineages(models):
    plane = ContinualLearningPlane(
        T_CLF.num_classes,
        LearningConfig(label_budget=48, labels_per_round=8,
                       sentinel_per_chunk=1, min_batch=2, min_holdout=2,
                       per_site=True),
        annotator=OracleAnnotator(iou_threshold=0.0, budget=48))
    streams = [_chunks(1300 + i, 3) for i in range(3)]
    multi = _multi(models, "torch", streams, plane, max_batch_chunks=3,
                   batch_window=0.05)
    site0 = plane._site_for(multi.scheduler.streams["cam0"])
    site0.state = "adapt"
    W_before = {n: np.array(s.W) for n, s in multi.scheduler.streams.items()}
    multi.run(learn=True)
    zoo = multi.scheduler.graph.zoo
    assert site0.trainer.rounds >= 1
    assert len(zoo.versions("fog-classifier[cam0]")) >= 2
    for name in ("cam1", "cam2"):
        site = plane._sites[name]
        assert site.state in ("monitor", "exhausted")
        assert site.trainer.rounds == 0
        assert zoo.versions(f"fog-classifier[{name}]") == [1]
        np.testing.assert_array_equal(multi.scheduler.streams[name].W,
                                      W_before[name])
    assert 0 < plane.annotator.labels_provided <= 48
    s = plane.summary()
    assert s["per_site"] and set(s["sites"]) == {"cam0", "cam1", "cam2"}


def test_replay_buffer_drop_archives_into_sibling():
    holdout, archive = ReplayBuffer(), ReplayBuffer()
    for i in range(6):
        holdout.add(np.full(3, float(i)), i % 2, t=float(i))
    assert holdout.drop_older_than(3.0, into=archive) == 3
    assert len(holdout) == 3 and len(archive) == 3
    xs, labels = archive.data()
    np.testing.assert_array_equal(xs[:, 0], [0.0, 1.0, 2.0])
    assert list(labels) == [0, 1, 0]
    assert holdout.drop_older_than(10.0) == 3 and len(archive) == 3


def test_trainer_pins_seed_anchor_through_trim():
    rng = np.random.default_rng(2)
    xs = np.concatenate([rng.normal(size=(200, 4)),
                         np.ones((200, 1))], -1).astype(np.float32)
    labels = rng.integers(0, 3, 200)
    zoo = ModelZoo()
    W0 = np.zeros((5, 3), np.float32)
    zoo.register("fog-classifier", {"W": W0})
    tr = BackgroundTrainer(zoo, num_classes=3, min_batch=4,
                           keep_snapshots=4, device="cpu")
    tr.seed_snapshot(W0, version=1)
    W = W0
    for round_ in range(8):
        for i in range(4):
            j = 4 * round_ + i
            tr.add_labeled(xs[j], int(labels[j]), t=float(j))
        rec = tr.maybe_train(W, t=float(round_), parent_version=1)
        W = rec.params["W"]
    assert len(tr.snapshots) == 4 and tr.snapshot_versions[0] == 1
    np.testing.assert_array_equal(tr.snapshots[0], W0)
    assert tr.snapshot_versions[-1] == rec.version
    omega = tr.fit_ensemble(versions={1, rec.version})
    snaps, om = tr.ensemble()
    assert omega is not None and snaps.shape[0] == 2 and om.shape == (2,)
    np.testing.assert_array_equal(snaps[0], W0)
    tr1 = BackgroundTrainer(zoo, num_classes=3, min_batch=4,
                            keep_snapshots=1, device="cpu")
    tr1.seed_snapshot(W0, version=1)
    for round_ in range(5):
        for i in range(4):
            j = 4 * round_ + i
            tr1.add_labeled(xs[j], int(labels[j]), t=float(j))
        tr1.maybe_train(W0, t=float(round_), parent_version=1)
    assert len(tr1.snapshots) == 1 and len(tr1.snapshot_versions) == 1


def test_health_posterior_concentrates_and_decays():
    h = HealthPosterior(decay=0.9)
    prior_std = h.std("fresh")
    for _ in range(40):
        h.observe_chunk("steady")
        h.update("steady", True)
    assert h.std("steady") < prior_std and h.mean("steady") > 0.8
    before = h.std("steady")
    for _ in range(200):
        h.observe_chunk("steady")
    assert h.std("steady") > before
    assert h.std("steady") == pytest.approx(prior_std, abs=1e-3)


def test_active_sentinel_targets_uncertain_stream_under_budget():
    plane = ContinualLearningPlane(4, LearningConfig(
        sentinel_mode="active", sentinel_per_chunk=2,
        sentinel_max_per_chunk=6))
    rng = np.random.default_rng(0)
    spent = {"steady": 0, "erratic": 0}
    chunks = 0
    for _ in range(120):
        for name in ("steady", "erratic"):
            chunks += 1
            plane.health.observe_chunk(name)
            k = plane._sentinel_allowance(name)
            spent[name] += k
            for _ in range(k):
                plane.health.update(
                    name, True if name == "steady" else bool(rng.random()
                                                             < 0.5))
    assert spent["steady"] + spent["erratic"] <= chunks * 2
    assert spent["erratic"] > 1.3 * spent["steady"]
    assert spent["steady"] > 0


def test_uniform_sentinel_unchanged():
    plane = ContinualLearningPlane(4, LearningConfig(sentinel_per_chunk=3))
    assert all(plane._sentinel_allowance("s") == 3 for _ in range(5))


def test_learning_run_reads_the_hand_off_fields(models):
    streams = [_chunks(1500 + i, 2) for i in range(3)]
    multi = _multi(models, "torch", streams, None, max_batch_chunks=3,
                   batch_window=0.05, hot_path="fused")
    sched = multi.scheduler
    multi.run(learn=False)
    assert sched.field_downloads.get("fog_features", 0) == 0
    assert sched.field_downloads.get("fog_scores", 0) == 0
    plane = ContinualLearningPlane(
        T_CLF.num_classes,
        LearningConfig(label_budget=16, sentinel_per_chunk=1),
        annotator=OracleAnnotator(iou_threshold=0.0, budget=16))
    multi2 = _multi(models, "torch", streams, plane, max_batch_chunks=3,
                    batch_window=0.05)
    multi2.run(learn=True)
    assert multi2.scheduler.field_downloads.get("fog_scores", 0) > 0


# ---------------------------------------------------------------------------
# The plane end to end: the JAX package against the port
# ---------------------------------------------------------------------------
MODES = {
    # the shared site promoted to every stream
    "global": dict(label_budget=48, labels_per_round=8,
                   sentinel_per_chunk=1, min_batch=2, min_holdout=2),
    # per-site lineages with Eq. 9 ensemble serving and the episode's
    # threshold overrides (the dynamic split): cam0 adapts, cam1/cam2 watch
    "per_site": dict(label_budget=36, labels_per_round=8,
                     sentinel_per_chunk=1, min_batch=2, min_holdout=2,
                     per_site=True, ensemble_serving=True,
                     sentinel_mode="active", adapt_theta_cls=0.3,
                     adapt_theta_loc=0.3),
}


@pytest.fixture(scope="module")
def plane_runs(models):
    streams = [_chunks(1300 + i, 4, drift=1.0 if i == 0 else 0.0)
               for i in range(3)]
    runs = {}
    for mode, kw in MODES.items():
        for side, Plane, Cfg, Ann in (
                ("jax", JPlane, JLearningConfig, JAnnotator),
                ("torch", ContinualLearningPlane, LearningConfig,
                 OracleAnnotator)):
            budget = kw["label_budget"]
            plane = Plane(CLF.num_classes, Cfg(**kw),
                          annotator=Ann(iou_threshold=0.0, budget=budget))
            multi = _multi(models, side, streams, plane, max_batch_chunks=3,
                           batch_window=0.05)
            if kw.get("per_site"):
                open_episode(plane, multi.scheduler, "cam0")
            else:
                plane.state = "adapt"
            ops.reset_launch_counts()
            multi.run(learn=True)
            runs[mode, side] = (plane, multi, ops.launch_counts())
    return runs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plane_end_to_end_matches_jax(plane_runs, mode):
    (jp, jm, _), (tp, tm, counts) = (plane_runs[mode, "jax"],
                                     plane_runs[mode, "torch"])
    assert tp.summary() == jp.summary()
    kinds = lambda m: [e["event"] for e in m.scheduler.monitor.events]  # noqa
    assert kinds(tm) == kinds(jm)
    zj, zt = jm.scheduler.graph.zoo, tm.scheduler.graph.zoo
    for name in jm.scheduler.streams:
        model = "fog-classifier" if mode == "global" else \
            f"fog-classifier[{name}]"
        assert zt.versions(model) == zj.versions(model)
        assert zt.promotion_log(model) == zj.promotion_log(model)
        Wj = np.asarray(jm.scheduler.streams[name].W)
        assert rel_err(tm.scheduler.streams[name].W, Wj) <= LEARN_RTOL
    # the reference's host-read discipline carries over with the plane on
    hj, ht = jm.scheduler.hot_path_stats, tm.scheduler.hot_path_stats
    for key in ("flushes", "host_syncs", "result_downloads",
                "crops_classified", "crops_budget", "ensemble_flushes",
                "ensemble_uploads"):
        assert ht[key] == hj[key], key
    assert ht["host_syncs"] == ht["flushes"]
    assert tm.scheduler.field_downloads == jm.scheduler.field_downloads
    assert counts == {name: 0 for name in [*ops.KERNELS, *ops.VJPS]}
    s = tp.summary()
    assert s["promotions"] >= 2 and s["labels_charged"] == s["label_budget"]


def test_per_site_plane_served_an_ensemble_and_left_other_sites(plane_runs):
    tp, tm, _ = plane_runs["per_site", "torch"]
    s = tp.summary()
    assert s["ensemble_promotions"] == 1
    assert tm.scheduler.streams["cam0"].ensemble is not None
    for name in ("cam1", "cam2"):
        assert s["sites"][name]["trainer"]["rounds"] == 0
        assert tm.scheduler.graph.zoo.versions(
            f"fog-classifier[{name}]") == [1]
    thresholds = tm.scheduler.monitor.events_of("stream_thresholds")
    assert [(e["stream"], e["theta_cls"]) for e in thresholds] == [
        ("cam0", 0.3), ("cam0", None)]


def test_plane_at_full_width_matches_jax():
    # the vpaas_video models at full width (features d+1 = 129 with
    # |x|^2 ~ 1.1e3: the largest steps the learner takes) on 2 streams x 2
    # chunks x 2 frames of serve's drifted workload, the LearningConfig of
    # serve --per-site-learning --ensemble-serving plus episode thresholds,
    # cam0's episode opened by hand; the JAX package's random weights
    import argparse
    import dataclasses

    from repro.configs.vpaas_video import CLASSIFIER, DETECTOR
    from repro.learning import DriftConfig as JDriftConfig
    from repro_torch.launch import serve
    args = argparse.Namespace(video_streams=2, video_chunks=2,
                              video_frames=2, per_site_learning=True,
                              ensemble_serving=True, label_budget=256,
                              drift_window=8)
    base = serve.learning_config(args)
    tcfg_l = dataclasses.replace(
        base, adapt_theta_cls=0.6, adapt_theta_loc=0.25,
        drift=dataclasses.replace(base.drift, warmup=args.video_chunks))
    fields = dataclasses.asdict(tcfg_l)
    jcfg_l = JLearningConfig(**dict(fields, drift=JDriftConfig(
        **fields["drift"])))
    streams = serve.drifted_streams(args)
    jd = jdet.init_detector(DETECTOR, jax.random.PRNGKey(0))
    jc = jclf.init_classifier(CLASSIFIER, jax.random.PRNGKey(1))
    runs = {}
    for side in ("jax", "torch"):
        if side == "jax":
            plane = JPlane(CLASSIFIER.num_classes, jcfg_l,
                           annotator=JAnnotator(iou_threshold=0.0,
                                                budget=256))
            multi = JMulti(JProtocol(DETECTOR, CLASSIFIER), jd, jc, streams,
                           max_batch_chunks=2, batch_window=0.05,
                           learning_plane=plane)
        else:
            plane = ContinualLearningPlane(
                CLASSIFIER.num_classes, tcfg_l,
                annotator=OracleAnnotator(iou_threshold=0.0, budget=256))
            multi = MultiStreamCoordinator(
                HighLowProtocol(tcfg.DETECTOR, tcfg.CLASSIFIER, device="cpu"),
                weights.from_numpy_tree(jd, "cpu"),
                weights.from_numpy_tree(jc, "cpu"), streams,
                max_batch_chunks=2, batch_window=0.05, learning_plane=plane,
                device="cpu")
        open_episode(plane, multi.scheduler, "cam0")
        multi.run(learn=True)
        runs[side] = (plane, multi.scheduler)
    (jp, js), (tp, ts) = runs["jax"], runs["torch"]
    assert tp.summary() == jp.summary()
    s = tp.summary()["sites"]["cam0"]
    assert s["trainer"]["rounds"] >= 1 and s["promotions"] >= 1
    assert [e["event"] for e in ts.monitor.events] == [
        e["event"] for e in js.monitor.events]
    assert rel_err(ts.streams["cam0"].W,
                   np.asarray(js.streams["cam0"].W)) <= LEARN_RTOL


def test_inline_learner_matches_jax(models):
    # StreamSpec.learner -> the scheduler's hitl.collect stage, no plane
    streams = [_chunks(1700 + i, 3) for i in range(2)]
    out = {}
    for side in ("jax", "torch"):
        Learner = (jinc.IncrementalLearner if side == "jax"
                   else tinc.IncrementalLearner)
        Ann = JAnnotator if side == "jax" else OracleAnnotator
        if side == "jax":
            from repro.core.coordinator import StreamSpec as Spec
        else:
            Spec = StreamSpec
        specs = [Spec(name=f"cam{i}", chunks=c,
                      learner=Learner(num_classes=CLF.num_classes,
                                      trigger=8, budget=60),
                      annotator=Ann(iou_threshold=0.0))
                 for i, c in enumerate(streams)]
        multi = _multi(models, side, specs, None, max_batch_chunks=2,
                       batch_window=0.05)
        res = multi.run(learn=True)
        out[side] = (specs, multi, res)
    (jspecs, jm, jres), (tspecs, tm, tres) = out["jax"], out["torch"]
    for js, ts in zip(jspecs, tspecs):
        assert (ts.learner.labels_used, ts.learner.updates_done) == (
            js.learner.labels_used, js.learner.updates_done)
        assert ts.learner.updates_done >= 1
        assert rel_err(tm.scheduler.streams[ts.name].W,
                       np.asarray(jm.scheduler.streams[js.name].W)) \
            <= LEARN_RTOL
        assert tres[ts.name].learner_summary == jres[js.name].learner_summary
    assert tm.monitor.counters.get("model_updates") == \
        jm.monitor.counters.get("model_updates")


def test_serve_learning_flags_run_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--video-streams",
         "2", "--video-chunks", "4", "--video-frames", "2", "--learning",
         "--per-site-learning", "--ensemble-serving", "--label-budget", "24",
         "--drift-window", "4", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "video graph: 2 streams, 8 chunks" in proc.stdout
    assert "learning plane [" in proc.stdout
    for name in ("cam0", "cam1"):
        assert f"    site {name} [" in proc.stdout
