"""Search engine — trial scheduling, sampling, early stopping.

Counterpart of ``analytics_zoo_tpu/automl/search.py`` (ref
pyzoo/zoo/automl/search/ray_tune_search_engine.py:36: trainables as Ray
actors, tune schedulers, ``TrialStopper``). The host decisions are JAX's,
line for line: the same configs from the same seed, the same median
stopping, successive halving and bayes proposals, the same trial list and
``trials.json``; a trial that raises is recorded as ``status="error"`` and
the search goes on.

``n_parallel > 1`` (or ``"auto"``: every card) runs the trials from a
thread pool, trial ``i`` under ``torch.cuda.device(i % n_cards)`` on a
CUDA stream of its own (JAX round-robins over ``jax.devices()``); on one
card the threads share it. The fits draw their randomness under
``common.device.RNG_LOCK``, so a trial computes what it would alone.
``device`` (``cuda`` unless the caller passes ``device="cpu"``; without
CUDA that raises) is where the pool places its workers; the builder's
models name their own device.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.automl import hp
from analytics_zoo_tpu_torch.automl.metrics import Evaluator
from analytics_zoo_tpu_torch.automl.model_builder import ModelBuilder
from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

#: where trials checkpoint and ``trials.json`` goes without ``logs_dir``
DEFAULT_LOGS_DIR = os.path.join(tempfile.gettempdir(),
                                "analytics_zoo_tpu_automl")
BAYES_ALGS = ("bayes", "tpe", "skopt", "bayesopt")
HALVING = ("hyperband", "asha", "successive_halving")


@dataclass
class Trial:
    trial_id: int
    config: dict
    metric_history: List[float] = field(default_factory=list)
    best_metric: Optional[float] = None
    status: str = "pending"           # pending|running|done|stopped|error
    error: Optional[str] = None
    checkpoint: Optional[str] = None
    wall_s: float = 0.0

    @property
    def last_metric(self):
        return self.metric_history[-1] if self.metric_history else None


class SearchEngine:
    """Abstract search engine (ref automl/search/base.py SearchEngine)."""

    def compile(self, data, search_space, n_sampling=1, epochs=1, **kwargs):
        raise NotImplementedError

    def run(self) -> List[Trial]:
        raise NotImplementedError

    def get_best_trial(self) -> Trial:
        raise NotImplementedError


class MedianStopper:
    """Stop a trial whose metric at epoch *e* is worse than the running
    median of completed trials at the same epoch (tune MedianStoppingRule
    analog; grace_period epochs always run)."""

    def __init__(self, mode: str, grace_period: int = 1):
        self.mode = mode
        self.grace_period = grace_period
        self._by_epoch: dict = {}

    def report(self, epoch: int, value: float):
        self._by_epoch.setdefault(epoch, []).append(value)

    def should_stop(self, epoch: int, value: float) -> bool:
        if epoch < self.grace_period:
            return False
        peers = self._by_epoch.get(epoch, [])
        if len(peers) < 3:
            return False
        med = float(np.median(peers))
        return value > med if self.mode == "min" else value < med


class BayesSearcher:
    """Sequential model-based sampler — the TPE idea behind the reference's
    skopt/bayesopt search algs (ref ray_tune_search_engine.py:36-172):
    split observed configs into a good quantile and the rest, sample
    candidates from a Parzen mixture over the good ones and keep the
    candidate maximizing the good/bad density ratio."""

    def __init__(self, space: dict, mode: str, seed: int = 0,
                 n_startup: int = 6, n_candidates: int = 24,
                 gamma: float = 0.3):
        self.space = space
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.gamma = gamma
        self._obs: List[tuple] = []

    def observe(self, config: dict, value: Optional[float]):
        if value is not None and np.isfinite(value):
            self._obs.append((config, float(value)))

    # -- per-key helpers ----------------------------------------------
    def _transform(self, key, v):
        s = self.space[key]
        return np.log(float(v)) if isinstance(s, hp.LogUniform) else float(v)

    def _untransform(self, key, t):
        s = self.space[key]
        v = float(np.exp(t)) if isinstance(s, hp.LogUniform) else float(t)
        if isinstance(s, (hp.QUniform, hp.QLogUniform)):
            v = hp._snap_to_q(v, s.q, s.lower, s.upper)
        if isinstance(s, hp.QRandInt):
            v = int(hp._snap_to_q(round(v), s.q, s.lower, s.upper - 1))
        elif isinstance(s, hp.RandInt):
            v = int(np.clip(round(v), s.lower, s.upper - 1))
        elif hasattr(s, "lower"):
            v = float(np.clip(v, s.lower, s.upper))
        return v

    def _numeric_keys(self):
        return [k for k, s in self.space.items()
                if isinstance(s, (hp.Uniform, hp.LogUniform, hp.RandInt))
                and not isinstance(s, hp.GridSearch)]

    def _categorical_keys(self):
        return [k for k, s in self.space.items()
                if isinstance(s, (hp.Choice, hp.GridSearch))]

    def _mixture_logpdf(self, key, obs_configs, t):
        centers = np.array([self._transform(key, c[key])
                            for c in obs_configs])
        bw = max(float(np.std(centers)), 1e-3 * (abs(float(
            np.mean(centers))) + 1.0))
        z = (t - centers) / bw
        return float(np.log(np.mean(np.exp(-0.5 * z * z) + 1e-12)) -
                     np.log(bw))

    def _cat_logp(self, key, obs_configs, v):
        s = self.space[key]
        cats = s.categories if isinstance(s, hp.Choice) else s.grid
        counts = {c: 1.0 for c in map(repr, cats)}  # Laplace smoothing
        for c in obs_configs:
            counts[repr(c[key])] = counts.get(repr(c[key]), 1.0) + 1.0
        total = sum(counts.values())
        return float(np.log(counts.get(repr(v), 1.0) / total))

    # -- API ----------------------------------------------------------
    def suggest(self) -> dict:
        if len(self._obs) < self.n_startup:
            return hp.sample_config(self.space, self.rng)
        vals = np.array([v for _, v in self._obs])
        order = np.argsort(vals if self.mode == "min" else -vals)
        n_good = max(2, int(np.ceil(self.gamma * len(order))))
        good = [self._obs[i][0] for i in order[:n_good]]
        bad = [self._obs[i][0] for i in order[n_good:]] or good

        def sample_candidate():
            cfg = hp.sample_config(self.space, self.rng)
            for k in self._numeric_keys():
                centers = [self._transform(k, c[k]) for c in good]
                center = centers[int(self.rng.integers(len(centers)))]
                bw = max(float(np.std(centers)), 1e-3 * (abs(center) + 1.0))
                cfg[k] = self._untransform(k, self.rng.normal(center, bw))
            for k in self._categorical_keys():
                pick = good[int(self.rng.integers(len(good)))][k]
                if self.rng.random() < 0.8:
                    cfg[k] = pick
            return cfg

        def score(cfg):
            s = 0.0
            for k in self._numeric_keys():
                t = self._transform(k, cfg[k])
                s += self._mixture_logpdf(k, good, t) \
                    - self._mixture_logpdf(k, bad, t)
            for k in self._categorical_keys():
                s += self._cat_logp(k, good, cfg[k]) \
                    - self._cat_logp(k, bad, cfg[k])
            return s

        cands = [sample_candidate() for _ in range(self.n_candidates)]
        return cands[int(np.argmax([score(c) for c in cands]))]


class LocalSearchEngine(SearchEngine):
    """Trial scheduling on the host driving the card(s).

    vs the reference's RayTuneSearchEngine (ray_tune_search_engine.py:36):
    - sampling: grid × random, or sequential bayes (``search_alg="bayes"``,
      the skopt/bayesopt analog);
    - schedulers: median stopping or successive halving
      (``scheduler="hyperband"``), matching tune's AsyncHyperBand idea;
    - packing: ``n_parallel>1`` (or ``"auto"``) runs trials from a thread
      pool, round-robin over the cards, each on a stream of its own;
    - fault isolation: a raising trial records status="error" and the
      search continues (ref tune trial fault tolerance).

    For homogeneous-architecture spaces see ``PopulationSearchEngine``
    (automl/population.py): K trials fused into one batched step.
    """

    def __init__(self, model_builder: ModelBuilder,
                 logs_dir: Optional[str] = None,
                 name: str = "exp", seed: int = 0, n_parallel=1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        logs_dir = DEFAULT_LOGS_DIR if logs_dir is None else logs_dir
        self.builder = model_builder
        self.logs_dir = os.path.join(logs_dir, name)
        self.name = name
        self.seed = seed
        self.n_parallel = n_parallel
        self.trials: List[Trial] = []
        self._compiled = False

    def compile(self, data, search_space: dict, n_sampling: int = 1,
                epochs: int = 1, validation_data=None, metric: str = "mse",
                mode: Optional[str] = None, scheduler: Optional[str] = None,
                batch_size: Optional[int] = None,
                search_alg: Optional[str] = None):
        """Materialize the trial list: the grid axes cross-product, each
        point sampled ``n_sampling`` times (ref RayTuneSearchEngine.compile
        ray_tune_search_engine.py:61). With ``search_alg="bayes"`` configs
        are proposed sequentially by the BayesSearcher instead
        (``n_sampling`` = total trial count)."""
        self.data = data
        self.validation_data = validation_data
        self.epochs = int(epochs)
        self.metric = metric
        self.mode = mode or Evaluator.get_metric_mode(metric)
        self.scheduler = scheduler
        self.batch_size = batch_size
        self.search_space = search_space
        self.search_alg = search_alg
        if search_alg in BAYES_ALGS:
            self.trials = [Trial(i, {}) for i in range(int(n_sampling))]
        else:
            rng = np.random.default_rng(self.seed)
            configs = [hp.sample_config(search_space, rng, gp)
                       for gp in hp.grid_points(search_space)
                       for _ in range(n_sampling)]
            self.trials = [Trial(i, c) for i, c in enumerate(configs)]
        self._compiled = True
        return self

    def _improved(self, v, best):
        return v < best if self.mode == "min" else v > best

    def _advance(self, trial: Trial, model, n_epochs: int,
                 stopper: Optional[MedianStopper] = None) -> bool:
        """Train ``n_epochs`` more epochs; returns False when the stopper
        fired. Checkpoints track the best epoch so get_best_model()
        restores the weights the reported metric came from."""
        ckpt = os.path.join(self.logs_dir, f"trial_{trial.trial_id}")
        for _ in range(n_epochs):
            epoch = len(trial.metric_history)
            value = float(model.fit_eval(
                self.data, validation_data=self.validation_data,
                epochs=1, metric=self.metric, batch_size=self.batch_size))
            trial.metric_history.append(value)
            if trial.best_metric is None or self._improved(value,
                                                           trial.best_metric):
                trial.best_metric = value
                model.save(ckpt)
                trial.checkpoint = ckpt
            if stopper:
                stopper.report(epoch, value)
                if stopper.should_stop(epoch, value):
                    return False
        return True

    def _run_trial(self, trial: Trial, stopper: Optional[MedianStopper]):
        t0 = time.time()
        trial.status = "running"
        try:
            model = self.builder.build(trial.config)
            survived = self._advance(trial, model, self.epochs, stopper)
            trial.status = "done" if survived else "stopped"
        except Exception as e:  # trial failure is data, not crash
            trial.status = "error"
            trial.error = f"{type(e).__name__}: {e}"
            logger.warning("trial %d failed: %s", trial.trial_id, trial.error)
        trial.wall_s = time.time() - t0
        return trial

    def _run_halving(self, eta: int = 3):
        """Successive halving (tune AsyncHyperBand analog): rungs at epoch
        budgets 1, eta, eta², ...; the worst (1 - 1/eta) of the survivors
        stop at each rung."""
        import math as _math
        rungs, r = [], 1
        while r < self.epochs:
            rungs.append(r)
            r *= eta
        rungs.append(self.epochs)

        alive = list(self.trials)
        models = {}
        t0 = {t.trial_id: time.time() for t in alive}
        for t in alive:
            t.status = "running"
            try:
                models[t.trial_id] = self.builder.build(t.config)
            except Exception as e:
                t.status = "error"
                t.error = f"{type(e).__name__}: {e}"
        alive = [t for t in alive if t.status == "running"]
        for target in rungs:
            for t in alive:
                try:
                    self._advance(t, models[t.trial_id],
                                  target - len(t.metric_history))
                except Exception as e:
                    t.status = "error"
                    t.error = f"{type(e).__name__}: {e}"
                    t.wall_s = time.time() - t0[t.trial_id]
            alive = [t for t in alive if t.status == "running"]
            if target < self.epochs and len(alive) > 1:
                k = max(1, int(_math.ceil(len(alive) / eta)))
                ranked = sorted(alive, key=lambda t: t.best_metric,
                                reverse=(self.mode == "max"))
                for t in ranked[k:]:
                    t.status = "stopped"
                    t.wall_s = time.time() - t0[t.trial_id]
                alive = ranked[:k]
        for t in alive:
            t.status = "done"
            t.wall_s = time.time() - t0[t.trial_id]

    def run(self) -> List[Trial]:
        if not self._compiled:
            raise RuntimeError("compile() before run()")
        os.makedirs(self.logs_dir, exist_ok=True)

        if self.search_alg in BAYES_ALGS:
            # sequential by construction: each proposal conditions on every
            # previous observation — n_parallel does not apply; median
            # stopping still does
            if self.n_parallel not in (1, None):
                logger.warning("search_alg='bayes' is sequential; "
                               "n_parallel=%r ignored", self.n_parallel)
            if self.scheduler in HALVING:
                logger.warning("scheduler=%r is not supported with bayes "
                               "search; using median stopping", self.scheduler)
            stopper = (MedianStopper(self.mode) if self.scheduler else None)
            searcher = BayesSearcher(self.search_space, self.mode,
                                     seed=self.seed)
            for t in self.trials:
                t.config = searcher.suggest()
                self._run_trial(t, stopper)
                searcher.observe(t.config, t.best_metric)
            self._write_summary()
            return self.trials

        if self.scheduler in HALVING:
            if self.n_parallel not in (1, None):
                logger.warning("successive halving runs rungs serially; "
                               "n_parallel=%r ignored", self.n_parallel)
            self._run_halving()
            self._write_summary()
            return self.trials

        stopper = (MedianStopper(self.mode)
                   if self.scheduler in ("median", "median_stopping") else None)
        n_par = self.n_parallel
        n_cards = (torch.cuda.device_count() if self.device.type == "cuda"
                   else 1)
        if n_par in ("auto", 0):
            n_par = n_cards
        n_par = int(n_par or 1)
        if n_par > 1:
            # pack trials over the cards: trial i runs under card i mod
            # n_cards on a stream of its own (JAX: jax.default_device)
            def worker(args):
                i, t = args
                if self.device.type != "cuda":
                    return self._run_trial(t, stopper)
                with torch.cuda.device(i % n_cards):
                    stream = torch.cuda.Stream()
                    with torch.cuda.stream(stream):
                        self._run_trial(t, stopper)
                    stream.synchronize()
                return t

            with ThreadPoolExecutor(max_workers=int(n_par)) as pool:
                list(pool.map(worker, enumerate(self.trials)))
        else:
            for t in self.trials:
                self._run_trial(t, stopper)
        self._write_summary()
        return self.trials

    def _write_summary(self):
        path = os.path.join(self.logs_dir, "trials.json")
        with open(path, "w") as f:
            json.dump([{
                "trial_id": t.trial_id,
                "config": {k: (v if isinstance(v, (int, float, str, bool,
                                                   type(None))) else str(v))
                           for k, v in t.config.items()},
                "metric_history": t.metric_history,
                "best_metric": t.best_metric, "status": t.status,
                "error": t.error, "wall_s": t.wall_s,
            } for t in self.trials], f, indent=1)

    def get_best_trial(self) -> Trial:
        done = [t for t in self.trials if t.best_metric is not None]
        if not done:
            errs = {t.trial_id: t.error for t in self.trials}
            raise RuntimeError(f"no successful trials: {errs}")
        key = (lambda t: t.best_metric)
        return min(done, key=key) if self.mode == "min" else max(done, key=key)
