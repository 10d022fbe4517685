"""Population search — K hyperparameter trials trained as one batched step.

Counterpart of ``analytics_zoo_tpu/automl/population.py`` (ref
pyzoo/zoo/automl/search/ray_tune_search_engine.py:36 runs each trial as a
separate Ray actor). When every trial shares the architecture and only
the optimizer's hyperparameters (learning rate, weight decay) and the
initial weights differ, the whole population trains together: the K
members' parameters are stacked (``torch.func.stack_module_state``), one
``torch.func.vmap`` of ``functional_call`` gives every member's loss and
gradients on the same batch, and one batched AdamW moves them all with a
``[K]`` learning rate and weight decay.

- **Members**: member k is ``model_creator(config_k)`` built under
  ``torch.manual_seed(config_k["seed"])`` (default: its index); a
  creator that loads weights keyed by the seed gives any start.
- **The update** is optax's ``adamw`` as JAX injects it
  (``inject_hyperparams(optax.adamw)``): ``scale_by_adam`` (moments,
  bias correction with the incremented count, ``mu_hat / (sqrt(nu_hat)
  + eps)``), then ``add_decayed_weights`` on every leaf (optax's mask is
  None: biases decay too), then ``-lr``.
- **The epoch**: ``n // batch_size`` batches in the order of the host's
  ``default_rng(seed).permutation``, as JAX's ``lax.scan`` takes them; the
  data sits on the device once and each batch is gathered there.
- **Evaluation** applies the members with ``train=False`` (no dropout
  inside ``vmap``, as JAX) to the whole validation set, and the metrics
  are JAX's ``Evaluator``'s.

Scope (JAX's): hyperparameters that change values, not the program —
``lr`` (required), ``weight_decay``, ``seed``. Structural axes belong in
``LocalSearchEngine``. ``device``: ``cuda`` unless the caller passes
``device="cpu"``; without CUDA that raises.
"""

from __future__ import annotations

import copy
import inspect
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, stack_module_state
from torch.func import vmap

from analytics_zoo_tpu_torch.automl import hp
from analytics_zoo_tpu_torch.automl.metrics import Evaluator
from analytics_zoo_tpu_torch.automl.model_builder import build_module
from analytics_zoo_tpu_torch.automl.search import (DEFAULT_LOGS_DIR,
                                                   SearchEngine, Trial)
from analytics_zoo_tpu_torch.common.device import (DeviceLike, as_tensor,
                                                   resolve_device)
from analytics_zoo_tpu_torch.learn.optimizers import Adam

VECTOR_KEYS = ("lr", "weight_decay", "seed")

# optax.adamw's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


class BatchedAdamW:
    """optax ``adamw`` over stacked members: every tensor has the members
    on its first axis, ``lr`` and ``wd`` are ``[K]`` tensors. The moments
    and ``scale_by_adam`` are ``learn.optimizers.Adam``'s over the
    stacked leaves; the decay and the rate are each member's."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: torch.Tensor,
                 wd: torch.Tensor):
        self.adam = Adam(beta1=B1, beta2=B2, epsilon=EPS)
        self.state = self.adam.init(list(params.values()))
        self.lr, self.wd = lr, wd
        self.count = 0

    @staticmethod
    def _per_member(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return v.view((-1,) + (1,) * (like.dim() - 1))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        updates = self.adam._adam([grads[n] for n in params], self.state,
                                  self.count)
        for p, u in zip(params.values(), updates):
            u = u + self._per_member(self.wd, p) * p
            p.add_(-self._per_member(self.lr, p) * u)
        self.count += 1


class PopulationSearchEngine(SearchEngine):
    """K trials over optimizer hyperparameters in one batched step."""

    def __init__(self, model_creator: Callable[[dict], object],
                 loss: str = "mse", logs_dir: Optional[str] = None,
                 name: str = "population", seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model_creator = model_creator
        self.loss_name = loss
        self.logs_dir = os.path.join(
            DEFAULT_LOGS_DIR if logs_dir is None else logs_dir, name)
        self.seed = seed
        self.trials: List[Trial] = []
        self._compiled = False
        self._member_params: Optional[Dict[str, torch.Tensor]] = None
        #: host seconds of the last ``run``'s epochs (training only)
        self.epoch_seconds: List[float] = []

    def compile(self, data, search_space: dict, n_sampling: int = 4,
                epochs: int = 1, validation_data=None, metric: str = "mse",
                mode: Optional[str] = None, batch_size: int = 32, **_):
        bad = [k for k, v in search_space.items()
               if isinstance(v, hp.Sampler) and k not in VECTOR_KEYS]
        if bad:
            raise ValueError(
                f"PopulationSearchEngine vectorizes {VECTOR_KEYS} only; "
                f"structural axes {bad} need LocalSearchEngine")
        if not isinstance(search_space.get("lr"), hp.Sampler) and \
                "lr" not in search_space:
            raise ValueError("search_space must define 'lr'")
        self.data = data
        self.validation_data = validation_data
        self.epochs = int(epochs)
        self.metric = metric
        self.mode = mode or Evaluator.get_metric_mode(metric)
        self.batch_size = int(batch_size)
        rng = np.random.default_rng(self.seed)
        configs = [hp.sample_config(search_space, rng)
                   for _ in range(int(n_sampling))]
        for i, c in enumerate(configs):
            c.setdefault("seed", i)
        self.trials = [Trial(i, c) for i, c in enumerate(configs)]
        self._compiled = True
        return self

    def _members(self):
        """The stacked parameters and buffers of the K members."""
        modules = [build_module(self.model_creator, t.config)
                   for t in self.trials]
        for m in modules:
            m.to(self.device).eval()
        params, buffers = stack_module_state(modules)
        params = {n: p.detach().clone() for n, p in params.items()}
        buffers = {n: b.detach().clone() for n, b in buffers.items()}
        base = copy.deepcopy(modules[0]).to("meta")
        return base, params, buffers

    def run(self) -> List[Trial]:
        from analytics_zoo_tpu_torch.learn import losses as loss_lib

        if not self._compiled:
            raise RuntimeError("compile() before run()")
        os.makedirs(self.logs_dir, exist_ok=True)
        t0 = time.time()
        dev = self.device

        x, y = (np.asarray(a) for a in self.data)
        vx, vy = (self.validation_data
                  if self.validation_data is not None else (x, y))
        base, params, buffers = self._members()
        loss_fn = loss_lib.get(self.loss_name)
        kwargs = ({"train": False} if "train" in
                  inspect.signature(base.forward).parameters else {})

        def member_loss(p, b, bx, by):
            out = functional_call(base, (p, b), (bx,), kwargs)
            return loss_fn(by, out).mean()

        member_step = vmap(grad_and_value(member_loss),
                           in_dims=(0, 0, None, None))
        member_predict = vmap(
            lambda p, b, bx: functional_call(base, (p, b), (bx,), kwargs),
            in_dims=(0, 0, None))
        opt = BatchedAdamW(
            params,
            torch.tensor([float(t.config["lr"]) for t in self.trials],
                         dtype=torch.float32, device=dev),
            torch.tensor([float(t.config.get("weight_decay", 0.0))
                          for t in self.trials], dtype=torch.float32,
                         device=dev))

        x_dev, y_dev = as_tensor(x, dev), as_tensor(y, dev)
        vx_dev = as_tensor(np.asarray(vx), dev)
        n = len(x)
        bs = min(self.batch_size, n)
        steps = max(1, n // bs)
        host_rng = np.random.default_rng(self.seed)
        for t in self.trials:
            t.status = "running"
        self.epoch_seconds = []
        for _ in range(self.epochs):
            e0 = time.perf_counter()
            order = torch.from_numpy(
                host_rng.permutation(n)[:steps * bs].reshape(steps, bs)
            ).to(dev)
            for s in range(steps):
                idx = order[s]
                grads, _ = member_step(params, buffers, x_dev[idx],
                                       y_dev[idx])
                opt.step(params, grads)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.epoch_seconds.append(time.perf_counter() - e0)
            with torch.no_grad():
                preds = member_predict(params, buffers, vx_dev)
            preds = preds.float().cpu().numpy()
            for k, t in enumerate(self.trials):
                value = float(Evaluator.evaluate(self.metric, vy, preds[k]))
                t.metric_history.append(value)
                better = t.best_metric is None or (
                    value < t.best_metric if self.mode == "min"
                    else value > t.best_metric)
                if better:
                    t.best_metric = value
        wall = time.time() - t0
        self._member_params = {**params, **buffers}
        for t in self.trials:
            t.status = "done"
            t.wall_s = wall  # one batched computation: shared wall clock
        return self.trials

    def get_best_trial(self) -> Trial:
        done = [t for t in self.trials if t.best_metric is not None]
        if not done:
            raise RuntimeError("no successful trials")
        key = (lambda t: t.best_metric)
        return min(done, key=key) if self.mode == "min" else max(done, key=key)

    def member_state_dict(self, k: int) -> Dict[str, torch.Tensor]:
        """Member ``k``'s final ``state_dict`` (on the host)."""
        return {n: v[k].detach().cpu().clone()
                for n, v in self._member_params.items()}

    def get_best_params(self) -> Dict[str, torch.Tensor]:
        """The best member's final ``state_dict`` (JAX: its params tree;
        ``convert.state_dict_to_flax`` gives that)."""
        return self.member_state_dict(self.get_best_trial().trial_id)
