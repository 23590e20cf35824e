"""The continual-learning plane: orchestrates drift -> label -> train ->
shadow-eval -> promote/rollback beside the live serving plane.

Attached to a :class:`~repro_torch.serving.graph.GraphScheduler`, the plane
hooks every finalized chunk (replacing the inline label-everything
``hitl.collect`` stage) and runs the §V loop *online*:

  1. **watch** — per-stream cascade statistics are recorded into the global
     :class:`~repro_torch.serving.monitor.Monitor`: mean fog confidence
     and fog-accept rate over uncertain regions, plus **sentinel
     spot-checks** — a trickle of the labor budget (``sentinel_per_chunk``
     labels) spent on randomly chosen regions, whose oracle-verified fog
     accuracy is the statistic the
     :class:`~repro_torch.learning.drift.DriftDetector` watches.
     Confidence alone cannot see a *confidently wrong* model (a fully
     swapped appearance distribution restores high confidence); verified
     disagreement can, and the sentinel labels build the promotion gate's
     unbiased holdout.  With ``sentinel_mode="active"`` the trickle is
     *scheduled*: spot-checks concentrate where the per-stream health
     posterior (:class:`~repro_torch.learning.drift.HealthPosterior`) is
     least certain, under the same long-run per-chunk allowance;
  2. **label** — on a drift event the site enters adaptation: uncertain
     regions are enqueued into the :class:`LabelingQueue` and the oracle
     labels top-K per chunk — most-uncertain-first with an epsilon-greedy
     exploration share — under the labor budget tau (labels actually
     issued are the only charge).  Queue labels train; sentinel labels
     (uniform-random over regions) build the gate's unbiased holdout;
  3. **train** — the :class:`BackgroundTrainer` replays issued labels
     through the Eq. 8 / proximal update off the serving path, registering
     each snapshot as a versioned candidate in the ``ModelZoo`` (lineage:
     parent version, data span, labels consumed);
  4. **promote** — the :class:`PromotionGate` shadow-evaluates candidates
     against a holdout replay slice; a winning candidate is promoted in the
     zoo and **hot-swapped** into live serving mid-run (in-flight chunks
     finish on the old weights; nothing stalls, nothing is lost);
  5. **rollback** — if the previously promoted model beats the live one by
     the gate's margin on the current holdout (both scored on the *same*
     data, so a refreshing holdout cannot fake a regression), the zoo
     rolls back to it (bit-identical weights) and hot-swaps it in.

Drift is a **per-camera** phenomenon: with ``per_site=True`` every stream
carries its own *site* — labeling queue, background trainer, holdout,
promotion gate, and zoo lineage (``fog-classifier[camK]``) — so a drift
episode in camera k trains, shadow-evaluates, and hot-swaps **only**
stream k's readout (``GraphScheduler.hot_swap(..., stream=k)``); every
other camera's weights are untouched bit-for-bit.  The labor budget tau
stays global: sites compete for the same human.  The default
(``per_site=False``) keeps the original single shared site promoted to all
streams.

An episode **closes** when the budget exhausts, or — per-site mode — when
the site's drift statistic recovers (the site returns to ``monitor`` and
stops consuming the shared budget).  At close the site fits the Eq. (9)
snapshot ensemble over its adaptation trajectory (anchored at the
pre-episode readout) and, with ``ensemble_serving=True``, promotes it into
live serving through ``hot_swap_ensemble`` when it beats the latest
promoted readout on the holdout.

PyTorch port of ``repro.learning.plane``.  The plane itself is host numpy
over the chunk results' fields (``LazyChunkResult`` materialises them from
the flush bundle), with every ``np.random.Generator`` seeded as in the
reference; each site's background trainer runs on the scheduler's device,
taken at :meth:`ContinualLearningPlane.attach`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Set

import numpy as np

from repro_torch.core import incremental
from repro_torch.core.hitl import UNLABELED, OracleAnnotator
from repro_torch.learning.drift import (DriftConfig, DriftDetector,
                                        HealthPosterior)
from repro_torch.learning.labeling import LabelCandidate, LabelingQueue
from repro_torch.learning.promotion import (PromotionGate, ReplayBuffer,
                                            ShadowEvaluator)
from repro_torch.learning.trainer import BackgroundTrainer
from repro_torch.serving.monitor import Monitor


@dataclass(frozen=True)
class LearningConfig:
    label_budget: int = 512        # the paper's human labor budget tau
    labels_per_round: int = 24     # oracle asks per finalized chunk
    sentinel_per_chunk: int = 1    # monitoring spot-checks per chunk
    explore_frac: float = 0.5      # epsilon-greedy share of queue issues
    queue_size: int = 2048
    min_batch: int = 16            # fresh labels per training round
    rule: str = "proximal"
    eta: float = 0.3
    passes: int = 2
    min_gain: float = 0.0
    min_holdout: int = 8
    rollback_margin: float = 0.1
    # label-queue aging: a promotion/rollback hot-swap re-scores queued
    # candidates against the new readout (their priorities reflect the
    # pre-swap model's uncertainty) and expires the ones the new model is
    # confident about (re-ranked uncertainty < expire_below)
    rescore_on_swap: bool = True
    expire_below: float = 0.05
    model_name: str = "fog-classifier"
    # per-site continual learning: one queue/trainer/holdout/gate + zoo
    # lineage per stream; promotions/rollbacks hot-swap only that stream
    per_site: bool = False
    # Eq. 9 ensemble serving: at episode close, hot-swap the snapshot
    # ensemble into live serving when it beats the latest promoted readout
    ensemble_serving: bool = False
    # sentinel scheduling: "uniform" spends sentinel_per_chunk everywhere;
    # "active" allocates the same long-run allowance by per-stream health-
    # posterior uncertainty (capped per chunk, never over-spending credit)
    sentinel_mode: str = "uniform"
    sentinel_max_per_chunk: int = 4
    health_decay: float = 0.97
    # drift-episode threshold adaptation: while a stream drives an open
    # episode its detector acceptance thresholds (theta_cls / theta_loc)
    # are overridden on the scheduler — a lower acceptance bar routes more
    # uncertain regions to the fog classifier, exactly where the episode's
    # label harvesting looks.  ``None`` (the default) leaves the global
    # ProtocolConfig thresholds in place and is bit-compatible with the
    # pre-adaptive scheduler.  Restored when the episode closes.
    adapt_theta_cls: Optional[float] = None
    adapt_theta_loc: Optional[float] = None
    drift: DriftConfig = field(default_factory=DriftConfig)


class _Site:
    """One learning lineage: a stream's (or, shared mode, the fleet's)
    queue, trainer, holdout, gate, and episode state."""

    def __init__(self, name: str, model_name: str, cfg: LearningConfig):
        self.name = name               # "" = shared site (all streams)
        self.model_name = model_name
        self.cfg = cfg
        self.queue = LabelingQueue(max_size=cfg.queue_size)
        self.evaluator = ShadowEvaluator(ReplayBuffer())
        # regime archive: pre-episode holdout samples displaced by a drift
        # event land here (already paid for) — the Eq. 9 ensemble is fit
        # and judged across regimes, which the per-candidate gate is not
        self.archive = ReplayBuffer(max_size=512)
        self.gate = PromotionGate(self.evaluator,
                                  min_holdout=cfg.min_holdout,
                                  min_gain=cfg.min_gain,
                                  rollback_margin=cfg.rollback_margin)
        self.trainer: Optional[BackgroundTrainer] = None
        self.state = "monitor"         # monitor | adapt | exhausted
        # monotone swap epoch for queue aging: zoo version numbers move
        # *backwards* on rollback, so staleness is tracked per hot-swap
        self.swap_epoch = 0
        self.hot_swaps = 0
        self.episodes = 0
        self.ensemble_promotions = 0
        self.drifted: Set[str] = set()
        self.recovery_logged = False
        # streams whose scheduler thresholds this site has overridden
        # (LearningConfig.adapt_theta_*); restored on episode close
        self.theta_overrides: Set[str] = set()

    def swap_target(self) -> Optional[str]:
        """hot_swap scope: the site's own stream, or None = every stream."""
        return self.name or None


class ContinualLearningPlane:
    """Drift-triggered, budgeted, versioned online learning loop."""

    def __init__(self, num_classes: int,
                 cfg: LearningConfig = LearningConfig(), *,
                 zoo=None, annotator: Optional[OracleAnnotator] = None,
                 monitor: Optional[Monitor] = None):
        self.cfg = cfg
        self.num_classes = num_classes
        self.zoo = zoo
        # a caller-supplied monitor is kept through attach(); by default
        # the plane adopts the scheduler's (hot_swap always logs there)
        self._own_monitor = monitor is None
        self.monitor = monitor or Monitor()
        self.annotator = annotator or OracleAnnotator(budget=cfg.label_budget)
        self.detector = DriftDetector(cfg.drift)
        self.health = HealthPosterior(decay=cfg.health_decay)
        self._sites: Dict[str, _Site] = {}
        if not cfg.per_site:
            self._sites[""] = _Site("", cfg.model_name, cfg)
        self.chunks_seen = 0
        self.sentinel_labels = 0
        self.sentinel_by_stream: Dict[str, int] = {}
        self._sentinel_credit = 0.0
        self._rng = np.random.default_rng(0)   # sentinel region picks
        self.device = None             # the trainers': the scheduler's

    # ------------------------------------------------------------------
    # Shared-mode compatibility surface: the pre-per-site API exposed the
    # single lineage's members directly; they now live on the default site
    # ------------------------------------------------------------------
    @property
    def _default_site(self) -> _Site:
        return self._sites[""]

    @property
    def queue(self) -> LabelingQueue:
        return self._default_site.queue

    @property
    def evaluator(self) -> ShadowEvaluator:
        return self._default_site.evaluator

    @property
    def gate(self) -> PromotionGate:
        return self._default_site.gate

    @property
    def trainer(self) -> Optional[BackgroundTrainer]:
        return self._default_site.trainer

    @property
    def swap_epoch(self) -> int:
        return self._default_site.swap_epoch

    @property
    def state(self) -> str:
        if not self.cfg.per_site:
            return self._default_site.state
        states = [s.state for s in self._sites.values()]
        if "adapt" in states:
            return "adapt"
        if states and all(s == "exhausted" for s in states):
            return "exhausted"
        return "monitor"

    @state.setter
    def state(self, value: str) -> None:
        assert not self.cfg.per_site, "per-site states live on the sites"
        self._default_site.state = value

    @property
    def hot_swaps(self) -> int:
        return sum(s.hot_swaps for s in self._sites.values())

    # ------------------------------------------------------------------
    def attach(self, scheduler) -> "ContinualLearningPlane":
        """Wire the plane into a live scheduler (its zoo, monitor and
        device)."""
        self.device = scheduler.device
        if self.zoo is None:
            self.zoo = scheduler.graph.zoo
        if self._own_monitor:
            self.monitor = scheduler.monitor
        for site in self._sites.values():
            self._ensure_trainer(site)
        scheduler.plane = self
        return self

    def _ensure_trainer(self, site: _Site) -> None:
        if site.trainer is None and self.zoo is not None:
            site.trainer = BackgroundTrainer(
                self.zoo, num_classes=self.num_classes,
                model_name=site.model_name, rule=self.cfg.rule,
                eta=self.cfg.eta, passes=self.cfg.passes,
                min_batch=self.cfg.min_batch, device=self.device)

    def _site_for(self, stream) -> _Site:
        key = stream.name if self.cfg.per_site else ""
        site = self._sites.get(key)
        if site is None:
            # first chunk from this camera: open its lineage in the zoo at
            # the stream's current readout (version 1 of fog-classifier[k])
            model_name = f"{self.cfg.model_name}[{stream.name}]"
            site = _Site(key, model_name, self.cfg)
            self.zoo.register(model_name, {"W": np.asarray(stream.W)})
            self._ensure_trainer(site)
            self._sites[key] = site
        return site

    def _live_W(self, site: _Site) -> np.ndarray:
        return np.asarray(self.zoo.get(site.model_name).params["W"])

    def _live_version(self, site: _Site) -> int:
        return self.zoo.get(site.model_name).version

    @property
    def live_W(self) -> np.ndarray:
        return self._live_W(self._default_site)

    @property
    def live_version(self) -> int:
        return self._live_version(self._default_site)

    # ------------------------------------------------------------------
    def _chunk_stats(self, res, fog_min_conf: float):
        """(mean max-confidence, fog-accept rate) over valid proposals."""
        valid = np.asarray(res.prop_valid)
        idx = np.nonzero(valid)
        if not len(idx[0]):
            return None
        conf = np.asarray(res.fog_scores).max(axis=-1)[idx]
        return float(conf.mean()), float((conf >= fog_min_conf).mean())

    def _harvest(self, site: _Site, stream, chunk, res, t: float,
                 exclude=frozenset()) -> int:
        """Enqueue this chunk's uncertain regions as label candidates.

        ``exclude`` holds the (frame, region) positions the sentinel
        already labelled this chunk: re-enqueueing them would charge the
        budget twice for one region and leak holdout samples into the
        training set."""
        n = 0
        valid = np.asarray(res.prop_valid)
        for f in range(valid.shape[0]):
            for i in np.nonzero(valid[f])[0]:
                if (f, int(i)) in exclude:
                    continue
                site.queue.push(LabelCandidate(
                    features=res.fog_features[f, i],
                    box=res.prop_boxes[f, i],
                    scores=res.fog_scores[f, i],
                    gt_boxes=chunk.gt_boxes[f],
                    gt_labels=chunk.gt_labels[f],
                    stream=stream.name, t=t,
                    model_version=site.swap_epoch))
                n += 1
        return n

    def _route_labels(self, site: _Site, issued, t: float) -> None:
        """Queue-issued labels train; only the *sentinel* stream (random
        regions, unbiased) feeds the holdout, so the gate scores candidates
        on the serving distribution rather than on the uncertainty-biased
        slice the queue selects for."""
        for item in issued:
            if item.label < 0:         # background / past-budget: not data
                continue
            site.trainer.add_labeled(item.candidate.features, item.label,
                                     t=t)

    # ------------------------------------------------------------------
    def _sentinel_allowance(self, stream_name: str) -> int:
        """Spot-checks to spend on this chunk.

        Uniform mode: the flat ``sentinel_per_chunk``.  Active mode: each
        chunk deposits the same allowance into a credit pool, and the
        chunk's stream withdraws in proportion to its share of the fleet's
        health-posterior uncertainty — a stream the plane is sure about
        (concentrated posterior) cedes its checks to the stream it is not.
        The pool never goes negative, so the long-run spend can only be
        *at most* uniform's — same labor budget, pointed where it buys the
        most information."""
        k0 = self.cfg.sentinel_per_chunk
        if self.cfg.sentinel_mode != "active":
            return k0
        self._sentinel_credit += k0
        stds = [self.health.std(s) for s in self.health.streams()]
        u = self.health.std(stream_name)
        mean_u = float(np.mean(stds)) if stds else 0.0
        share = 1.0 if mean_u <= 0.0 else u / mean_u
        k = int(round(k0 * share))
        k = max(0, min(k, self.cfg.sentinel_max_per_chunk,
                       int(self._sentinel_credit)))
        self._sentinel_credit -= k
        return k

    def _sentinel(self, site: _Site, stream, chunk, res, t: float):
        """Oracle spot-check on random regions: the verified-accuracy drift
        statistic (and the gate's unbiased holdout data).

        Returns (accuracy sample or None, set of checked (frame, region)
        positions — excluded from harvesting so a region is never charged
        twice or shared between holdout and training set)."""
        checked: set = set()
        if self.annotator.remaining == 0:
            return None, checked
        pos = np.argwhere(np.asarray(res.prop_valid))
        if not len(pos):
            return None, checked
        alloc = self._sentinel_allowance(stream.name)
        k = min(alloc, len(pos))
        if self.cfg.sentinel_mode == "active" and alloc > k:
            self._sentinel_credit += alloc - k   # refund the unusable part
        if k <= 0:
            return None, checked
        picks = pos[self._rng.choice(len(pos), size=k, replace=False)]
        correct, n = 0, 0
        for f, i in picks:
            labels = self.annotator.label_regions(
                res.prop_boxes[f, i][None, :], chunk.gt_boxes[f],
                chunk.gt_labels[f])
            lab = int(labels[0])
            if lab == UNLABELED:       # budget ran out mid-check
                break
            checked.add((int(f), int(i)))
            self.sentinel_labels += 1
            self.sentinel_by_stream[stream.name] = (
                self.sentinel_by_stream.get(stream.name, 0) + 1)
            if lab < 0:                # background region: no class verdict
                continue
            n += 1
            hit = int(np.argmax(res.fog_scores[f, i])) == lab
            correct += int(hit)
            self.health.update(stream.name, hit)
            # sentinel labels are uniform-random over regions: they build
            # the unbiased holdout the promotion gate scores against
            site.evaluator.holdout.add(res.fog_features[f, i], lab, t=t)
        return (correct / n if n else None), checked

    # ------------------------------------------------------------------
    def on_chunk(self, scheduler, stream, chunk, res, t: float,
                 mode: str) -> None:
        """Finalize hook: one finished chunk drives one plane step."""
        if mode != "cloud":            # fallback results carry no features
            return
        self.chunks_seen += 1
        site = self._site_for(stream)
        self._ensure_trainer(site)
        self.health.observe_chunk(stream.name)
        if site.state == "monitor" and self.annotator.remaining == 0:
            # the sentinel trickle spent the whole budget while healthy:
            # monitoring is blind from here on — say so, don't pretend
            site.state = "exhausted"
            self.monitor.log_event("budget_exhausted", t=t,
                                   site=site.name or None,
                                   labels=self.annotator.labels_provided)
            return
        pcfg = scheduler.graph.protocol.pcfg
        stats = self._chunk_stats(res, pcfg.fog_min_conf)
        if stats is not None:
            conf, accept = stats
            self.monitor.record(f"fog_confidence[{stream.name}]", conf, t)
            self.monitor.record(f"fog_accept[{stream.name}]", accept, t)
        # the drift statistic is oracle-VERIFIED accuracy (sentinel
        # spot-checks): confidence cannot see a confidently-wrong model
        acc, checked = self._sentinel(site, stream, chunk, res, t)
        if acc is not None:
            self.monitor.record(f"sentinel_acc[{stream.name}]", acc, t)
            ev = self.detector.observe(stream.name, acc, t)
            if ev is not None:
                site.drifted.add(stream.name)
                self.monitor.incr("drift_events")
                self.monitor.log_event("drift", t=t, stream=stream.name,
                                       site=site.name or None,
                                       stat=ev.stat, baseline=ev.baseline,
                                       severity=ev.severity,
                                       onset_t=ev.onset_t)
                if site.state == "monitor":
                    # entering adaptation: labels from before this episode
                    # describe the old regime — the snapshots keep that
                    # history, the train/holdout buffers must not.  Repeat
                    # events *during* adaptation (other streams catching
                    # up, or cooldown expiry while still drifted) must NOT
                    # re-drop the freshly-bought labels.
                    site.trainer.drop_older_than(ev.onset_t)
                    site.evaluator.holdout.drop_older_than(
                        ev.onset_t, into=site.archive)
                    site.state = "adapt"
                    site.episodes += 1
                    site.recovery_logged = False
                    # anchor Eq. 9's W_0: the pre-episode readout opens the
                    # episode's snapshot lineage
                    site.trainer.seed_snapshot(self._live_W(site),
                                               self._live_version(site))
                # every drifted stream (episode opener or a later joiner)
                # gets the adaptation thresholds while the episode runs
                self._apply_theta(site, scheduler, stream.name, t)

        if site.state == "adapt":
            self._adapt_step(site, scheduler, stream, chunk, res, t,
                             exclude=checked)
        if site.state == "adapt":
            # rollback is re-checked only while the site actively adapts;
            # an episode close runs its own final check *before* gating
            # the ensemble (see _close_episode).  A settled site must not
            # re-litigate old promotions against a holdout that keeps
            # refreshing with mixed-regime sentinels — a post-close
            # rollback would silently clear a served Eq. 9 ensemble and
            # re-open an episode that has no drifted stream to close on.
            self._maybe_rollback(site, scheduler, t)

    # ------------------------------------------------------------------
    def _adapt_step(self, site: _Site, scheduler, stream, chunk, res,
                    t: float, exclude=frozenset()) -> None:
        self._harvest(site, stream, chunk, res, t, exclude=exclude)
        issued = site.queue.issue(self.annotator, self.cfg.labels_per_round,
                                  explore=self.cfg.explore_frac,
                                  rng=self._rng)
        self._route_labels(site, issued, t)

        parent = self._live_version(site)
        rec = site.trainer.maybe_train(self._live_W(site), t,
                                       parent_version=parent)
        if rec is not None:
            decision = site.gate.evaluate(self._live_W(site),
                                          rec.params["W"], t)
            rec.lineage["eval_score"] = decision["cand_score"]
            if decision["promote"]:
                self.zoo.promote(site.model_name, rec.version)
                site.gate.note_promotion(decision["cand_score"])
                inflight = scheduler.hot_swap(rec.params["W"],
                                              version=rec.version, t=t,
                                              stream=site.swap_target())
                site.hot_swaps += 1
                self.monitor.log_event(
                    "promotion", t=t, version=rec.version, parent=parent,
                    site=site.name or None,
                    score=decision["cand_score"],
                    live_score=decision["live_score"], inflight=inflight)
                self._age_queue(rec.params["W"], t, site=site)

        if self.annotator.remaining == 0:
            # labor budget spent: close the episode with the Eq. 9 ensemble
            # and one last rollback check of the final promotion
            self._close_episode(site, scheduler, t, reason="budget")
        elif site.drifted:
            recovered = [s for s in site.drifted
                         if self.detector.recovered(s)]
            if self.cfg.per_site:
                # a recovered site closes its episode and returns to
                # monitoring — it stops drawing on the shared budget, and
                # its Eq. 9 ensemble (old + new regime snapshots) can take
                # over serving for that camera.  Deliberately NOT gated on
                # promotions: a false-alarm episode (noisy sentinel on a
                # healthy camera — nothing ever beats the live model) must
                # close the moment the statistic is back, or it would
                # bleed the shared tau forever
                if recovered and len(recovered) == len(site.drifted):
                    self._close_episode(site, scheduler, t,
                                        reason="recovered")
            elif site.gate.promotions > 0:
                # shared site: a recovered stream re-anchors its baseline
                # at the recovered level so a *new* episode is judged
                # against it (and repeat events stop firing); adaptation
                # itself continues while budget remains — tau is allocated
                # to the episode
                for s in recovered:
                    self.detector.rebaseline(s)
                    site.drifted.discard(s)
                self._restore_theta(site, scheduler, t, streams=recovered)
                if not site.drifted and not site.recovery_logged:
                    site.recovery_logged = True
                    self.monitor.log_event("recovered", t=t)

    # ------------------------------------------------------------------
    def _close_episode(self, site: _Site, scheduler, t: float,
                       reason: str) -> None:
        """Episode end: settle the last promotion, fit (and maybe serve)
        the Eq. 9 ensemble, then either freeze the site (budget gone) or
        re-arm it (recovered)."""
        # the final rollback check runs FIRST: gating the ensemble against
        # a live readout the very next statement rolls back would promote
        # an ensemble and then silently clear it (hot_swap supersedes),
        # leaving counters claiming an ensemble serves when none does
        if reason == "budget":
            site.state = "exhausted"   # a rollback must not re-open adapt
        self._maybe_rollback(site, scheduler, t)
        # Eq. 9 over the episode's *served* lineage: the seed anchor W_0
        # plus every promoted snapshot — candidates the gate rejected
        # already lost on the holdout and would only dilute the mix
        lineage = set(self.zoo.promotion_log(site.model_name))
        if site.trainer.seed_version is not None:
            lineage.add(site.trainer.seed_version)
        extra = site.archive.data() if len(site.archive) else None
        fit_extra = extra
        if extra is not None and len(site.trainer.buffer):
            # regime-balanced fit: the archive is a thin slice (sentinel
            # trickle) next to the episode's label buffer, and a ridge fit
            # follows the mass — tile it to parity so omega treats "the
            # regime the site served before" and "the regime it serves
            # now" as equals, which is the robustness the ensemble is FOR
            reps = max(1, round(len(site.trainer.buffer) / len(extra[0])))
            fit_extra = (np.tile(extra[0], (reps, 1)),
                         np.tile(extra[1], reps))
        omega = site.trainer.fit_ensemble(versions=lineage,
                                          extra=fit_extra)
        ens_acc = live_acc = None
        if omega is not None:
            snaps, omega = site.trainer.ensemble()
            # drop near-zero-omega snapshots BEFORE gating, so the gate
            # scores exactly the (smaller) ensemble that would serve — a
            # pruned stack shrinks the scheduler's (G, T, d+1, C) upload
            # and the T-fold serving einsum
            n_fit = int(snaps.shape[0])
            snaps, omega, _ = incremental.prune_ensemble(snaps, omega)
            decision = site.gate.evaluate_ensemble(self._live_W(site),
                                                   snaps, omega, t,
                                                   extra=extra)
            ens_acc = decision["ens_score"]
            live_acc = decision["live_score"]
            if self.cfg.ensemble_serving and decision["promote"]:
                inflight = scheduler.hot_swap_ensemble(
                    snaps, omega, version=self._live_version(site), t=t,
                    stream=site.swap_target())
                site.hot_swaps += 1
                site.ensemble_promotions += 1
                self.monitor.log_event(
                    "ensemble_promotion", t=t, site=site.name or None,
                    snapshots=int(snaps.shape[0]), score=ens_acc,
                    live_score=live_acc, inflight=inflight,
                    pruned=n_fit - int(snaps.shape[0]))
        # the episode's threshold overrides end with the episode: an
        # exhausted site buys no more labels, and a recovered one is back
        # at the bit-compatible defaults
        self._restore_theta(site, scheduler, t)
        if reason == "budget":
            self.monitor.log_event("budget_exhausted", t=t,
                                   site=site.name or None,
                                   labels=self.annotator.labels_provided,
                                   ensemble_acc=ens_acc,
                                   live_acc=(live_acc if live_acc is not None
                                             else site.evaluator.score(
                                                 self._live_W(site))))
        else:                          # recovered (per-site episodes only)
            for s in list(site.drifted):
                self.detector.rebaseline(s)
            site.drifted.clear()
            site.state = "monitor"
            site.recovery_logged = True
            self.monitor.log_event("recovered", t=t, site=site.name or None,
                                   ensemble_acc=ens_acc, live_acc=live_acc)

    # ------------------------------------------------------------------
    def _apply_theta(self, site: _Site, scheduler, stream_name: str,
                     t: float) -> None:
        """Override one drifted stream's detector thresholds for the
        episode (no-op unless ``adapt_theta_*`` is configured)."""
        cfg = self.cfg
        if cfg.adapt_theta_cls is None and cfg.adapt_theta_loc is None:
            return
        if not hasattr(scheduler, "set_stream_thresholds"):
            return
        if stream_name in site.theta_overrides:
            return
        scheduler.set_stream_thresholds(stream_name,
                                        theta_cls=cfg.adapt_theta_cls,
                                        theta_loc=cfg.adapt_theta_loc, t=t)
        site.theta_overrides.add(stream_name)

    def _restore_theta(self, site: _Site, scheduler, t: float,
                       streams=None) -> None:
        """Put overridden streams back on the global defaults."""
        names = (set(site.theta_overrides) if streams is None
                 else site.theta_overrides & set(streams))
        for s in sorted(names):
            scheduler.set_stream_thresholds(s, theta_cls=None,
                                            theta_loc=None, t=t)
            site.theta_overrides.discard(s)

    # ------------------------------------------------------------------
    def _age_queue(self, W, t: float, site: Optional[_Site] = None) -> None:
        """Queue aging on a hot-swap: candidates enqueued under the old
        readout re-rank by the new model's uncertainty (or expire when the
        new model is confident) before competing for the labor budget."""
        site = site if site is not None else self._default_site
        site.swap_epoch += 1
        if not self.cfg.rescore_on_swap or not len(site.queue):
            return
        aged = site.queue.rescore(W, version=site.swap_epoch,
                                  expire_below=self.cfg.expire_below)
        self.monitor.log_event("queue_rescore", t=t, epoch=site.swap_epoch,
                               site=site.name or None, **aged)

    # ------------------------------------------------------------------
    def _maybe_rollback(self, site: _Site, scheduler, t: float) -> None:
        log = self.zoo.promotion_log(site.model_name)
        if len(log) < 2:
            return                      # nothing promoted to fall back to
        prev = self.zoo.get_version(site.model_name, log[-2])
        do, score = site.gate.should_rollback(self._live_W(site),
                                              prev.params["W"])
        if not do:
            return
        bad_version = self._live_version(site)
        rec = self.zoo.rollback(site.model_name)
        site.gate.note_rollback()
        inflight = scheduler.hot_swap(rec.params["W"], version=rec.version,
                                      t=t, stream=site.swap_target())
        site.hot_swaps += 1
        self.monitor.log_event("rollback", t=t, from_version=bad_version,
                               to_version=rec.version, score=score,
                               site=site.name or None, inflight=inflight)
        self._age_queue(rec.params["W"], t, site=site)
        if site.state == "exhausted":
            return
        site.state = "adapt"           # the regression needs fixing

    # ------------------------------------------------------------------
    def _site_summary(self, site: _Site) -> Dict[str, Any]:
        return {
            "state": site.state,
            "queue": dict(site.queue.stats),
            "holdout": len(site.evaluator.holdout),
            "trainer": site.trainer.summary() if site.trainer else {},
            "promotions": site.gate.promotions,
            "rollbacks": site.gate.rollbacks,
            "hot_swaps": site.hot_swaps,
            "episodes": site.episodes,
            "ensemble_promotions": site.ensemble_promotions,
            "live_version": (self._live_version(site)
                             if self.zoo is not None
                             and site.model_name in self.zoo else None),
        }

    def summary(self) -> Dict[str, Any]:
        sites = list(self._sites.values())
        merged_queue: Dict[str, int] = {}
        for s in sites:
            for k, v in s.queue.stats.items():
                merged_queue[k] = merged_queue.get(k, 0) + v
        trainer_rounds = sum(s.trainer.summary()["rounds"]
                             for s in sites if s.trainer)
        out = {
            "state": self.state,
            "per_site": self.cfg.per_site,
            "chunks_seen": self.chunks_seen,
            "drift_events": len(self.detector.events),
            "labels_charged": self.annotator.labels_provided,
            "sentinel_labels": self.sentinel_labels,
            "sentinel_by_stream": dict(self.sentinel_by_stream),
            "label_budget": self.annotator.budget,
            "queue": merged_queue,
            "holdout": sum(len(s.evaluator.holdout) for s in sites),
            "promotions": sum(s.gate.promotions for s in sites),
            "rollbacks": sum(s.gate.rollbacks for s in sites),
            "ensemble_promotions": sum(s.ensemble_promotions
                                       for s in sites),
            "hot_swaps": self.hot_swaps,
        }
        if not self.cfg.per_site:
            site = self._default_site
            out["trainer"] = site.trainer.summary() if site.trainer else {}
            out["live_version"] = (self._live_version(site)
                                   if self.zoo is not None
                                   and site.model_name in self.zoo
                                   else None)
        else:
            out["trainer"] = {"rounds": trainer_rounds}
            out["sites"] = {s.name: self._site_summary(s) for s in sites}
        return out
