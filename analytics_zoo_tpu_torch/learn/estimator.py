"""Orca-style Estimator over a PyTorch module: fit, evaluate, predict.

Counterpart of ``analytics_zoo_tpu/learn/estimator.py``
(``Estimator.from_torch`` / ``JaxEstimator``; ref
``pyzoo/zoo/orca/learn/pytorch/estimator.py:35``). The JAX package turns
a torch module into a JAX function and trains it in a jitted step; the
port trains the ``nn.Module`` as it is, on one device (``cuda`` unless
the caller passes ``device="cpu"``; without CUDA that raises), eagerly:

- **The step** follows ``step_fn``: the module's forward with
  ``train=True`` when its ``forward`` takes ``train`` (and
  ``module.train()`` for layers that read it), the mean of the
  per-sample loss, its gradients, clipping, the optimizer's update.
  Dropout draws from the device's generator seeded from ``seed`` and the
  step, inside ``torch.random.fork_rng`` so the caller's streams are left
  as they were (the bits differ from JAX's).
- **Clipping** follows optax: ``clip_by_global_norm`` scales by
  ``max_norm / norm`` unless ``norm < max_norm``; constant clipping clips
  at ``max(|lo|, |hi|)``. Changing it rebuilds the optimizer state, as the
  JAX estimator re-initialises its optax chain.
- **fit** takes one step per batch, drops the final partial batch, shuffles
  in the JAX package's order (``data/dataset.py``) and returns the mean
  loss of each epoch. Step losses stay on the device and are read back
  once per ``summary_interval`` steps, never once per step.
- **evaluate** pads the final batch and masks the padded rows out of the
  loss and the metrics; **predict** runs in ``torch.inference_mode()`` and
  drops the padded rows.
- **save**/**load** write and read ``estimator.pt`` (``torch.save``):
  the module's ``state_dict``, the optimizer state and the step and epoch
  counts. Reading the JAX package's checkpoints is ROADMAP A6.

Not ported yet (ROADMAP A3): meshes and strategies other than ``"dp"`` on
one device, ``steps_per_loop``, ``cache="device"``, checkpoint triggers
and ``model_dir`` snapshots, ``auto_resume``, TensorBoard writers and
``profile``.
"""

from __future__ import annotations

import inspect
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.device import (DeviceLike, as_tensor,
                                                   resolve_device, to_numpy)
from analytics_zoo_tpu_torch.data.dataset import (ShardedDataset,
                                                  to_sharded_dataset,
                                                  tree_map)
from analytics_zoo_tpu_torch.data.shard import HostXShards, XShards
from analytics_zoo_tpu_torch.learn import losses as loss_lib
from analytics_zoo_tpu_torch.learn import metrics as metric_lib
from analytics_zoo_tpu_torch.learn.optimizers import Optimizer

CHECKPOINT = "estimator.pt"


def _n_inputs(model: nn.Module, sig: inspect.Signature) -> Optional[int]:
    """How many inputs the model's forward takes: a keras graph's input
    count, else its required positional parameters (None when it takes
    ``*args``)."""
    graph_inputs = getattr(model, "graph_inputs", None)
    if graph_inputs is not None:
        return len(graph_inputs)
    n = 0
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return None
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) and \
                p.default is p.empty:
            n += 1
    return n


class Estimator:
    """Factory (ref orca/learn/tf/estimator.py Estimator)."""

    @staticmethod
    def from_torch(*, model: nn.Module, loss, optimizer="adam", metrics=None,
                   model_dir: Optional[str] = None, strategy="dp",
                   seed: int = 0, device: DeviceLike = None
                   ) -> "TorchEstimator":
        """Train a PyTorch ``nn.Module`` (ref
        pyzoo/zoo/orca/learn/pytorch/estimator.py:35
        Estimator.from_torch)."""
        return TorchEstimator(model, loss=loss, optimizer=optimizer,
                              metrics=metrics, model_dir=model_dir,
                              strategy=strategy, seed=seed, device=device)


class TorchEstimator:
    """The engine (ref Scala Estimator zoo/.../pipeline/estimator/
    Estimator.scala:68-309), on one device."""

    def __init__(self, model: nn.Module, loss, optimizer="adam",
                 metrics=None, model_dir: Optional[str] = None,
                 strategy="dp", seed: int = 0, device: DeviceLike = None):
        if strategy not in (None, "dp"):
            raise NotImplementedError(
                f"strategy {strategy!r}: the port trains on one device; "
                "meshes and sharding strategies are ROADMAP A9")
        if model_dir is not None:
            raise NotImplementedError(
                "model_dir snapshots and checkpoint triggers are not ported "
                "yet (ROADMAP A3); use save()/load()")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_lib.get(loss)
        self.optimizer = Optimizer.get(optimizer)
        self.metrics = [metric_lib.get(m) for m in (metrics or [])]
        self.seed = int(seed)
        #: every step's loss, read back once per summary window
        self.step_losses: List[float] = []
        self._params = [p for p in self.model.parameters() if p.requires_grad]
        self._opt_state: Optional[dict] = None
        self._grad_clip = None  # ("norm", v) | ("const", min, max)
        self._epoch = 0
        self._py_step = 0
        sig = inspect.signature(self.model.forward)
        self._takes_train = "train" in sig.parameters
        self._n_inputs = _n_inputs(self.model, sig)

    # ------------- gradient clipping (ref spark_estimator.py:150-180) ----
    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        self._grad_clip = ("const", float(min_value), float(max_value))
        self._opt_state = None

    def set_l2_norm_gradient_clipping(self, clip_norm: float):
        self._grad_clip = ("norm", float(clip_norm))
        self._opt_state = None

    def clear_gradient_clipping(self):
        self._grad_clip = None
        self._opt_state = None

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self._grad_clip is None:
            return grads
        if self._grad_clip[0] == "const":
            mag = max(abs(self._grad_clip[1]), abs(self._grad_clip[2]))
            return [g.clamp(-mag, mag) for g in grads]
        max_norm = self._grad_clip[1]
        # optax global_norm: the square root of the summed squares
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < max_norm
        return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]

    # ------------- the step ----------------------------------------------
    def _ensure_opt_state(self) -> dict:
        if self._opt_state is None:
            # "count": optax's update count, which restarts with the state
            self._opt_state = {"count": 0,
                               **self.optimizer.init(self._params)}
        return self._opt_state

    def _tensors(self, tree):
        return tree_map(lambda a: as_tensor(a, self.device), tree)

    def _forward(self, x, train: bool):
        args = x if isinstance(x, (tuple, list)) else (x,)
        kwargs = {"train": train} if self._takes_train else {}
        return self.model(*args, **kwargs)

    def _train_step(self, x, y) -> torch.Tensor:
        state = self._ensure_opt_state()
        x, y = self._tensors(x), self._tensors(y)
        cuda = self.device.type == "cuda"
        devices = [self.device.index if self.device.index is not None
                   else torch.cuda.current_device()] if cuda else []
        step_seed = (self.seed * 1000003 + self._py_step) & 0x7FFFFFFFFFFF
        with torch.random.fork_rng(devices=devices):
            torch.random.default_generator.manual_seed(step_seed)
            if cuda:
                with torch.cuda.device(self.device):
                    torch.cuda.manual_seed(step_seed)
            preds = self._forward(x, train=True)
        loss = self.loss_fn(y, preds).mean()
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._params, grads)]
        with torch.no_grad():
            self.optimizer.step(self._params, self._clip(grads), state,
                                state["count"])
        state["count"] += 1
        return loss.detach()

    # ------------- public API --------------------------------------------
    def _dataset(self, data, feature_cols, label_cols) -> ShardedDataset:
        """``data`` as a ShardedDataset. A single-input model fed one
        input per DataFrame column (the reference's DataFrame
        convention) gets the scalar columns stacked into one matrix."""
        ds = to_sharded_dataset(data, feature_cols, label_cols)
        if (self._n_inputs == 1 and isinstance(ds.x, tuple)
                and all(np.ndim(a) == 1 for a in ds.x)):
            return ShardedDataset(np.column_stack(ds.x), ds.y)
        return ds

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_cols=None, label_cols=None, validation_data=None,
            summary_interval: int = 20,
            shuffle: bool = True) -> Dict[str, List[float]]:
        """(ref orca/learn/tf/estimator.py fit:486) One optimizer step per
        batch of ``batch_size``; returns ``{"loss": [mean loss of each
        epoch], "val_<metric>": [...]}``. ``data`` and ``validation_data``
        take what ``to_sharded_dataset`` takes (``feature_cols`` and
        ``label_cols`` name a DataFrame's columns)."""
        ds = self._dataset(data, feature_cols, label_cols)
        val_ds = (self._dataset(validation_data, feature_cols, label_cols)
                  if validation_data is not None else None)
        history: Dict[str, List[float]] = {"loss": []}
        target = self._epoch + epochs
        while self._epoch < target:
            history["loss"].append(self._run_epoch(
                ds, batch_size, shuffle, max(1, int(summary_interval))))
            self._epoch += 1
            if val_ds is not None:
                for k, v in self.evaluate(val_ds, batch_size).items():
                    history.setdefault("val_" + k, []).append(v)
        return history

    def _run_epoch(self, ds: ShardedDataset, batch_size: int, shuffle: bool,
                   summary_interval: int) -> float:
        losses: List[float] = []
        pending: List[torch.Tensor] = []

        def flush():
            # one read-back per window of step losses
            if pending:
                vals = torch.stack(pending).double().cpu().tolist()
                losses.extend(vals)
                self.step_losses.extend(vals)
                pending.clear()

        self.model.train(True)
        for x, y, _ in ds.iter_batches(batch_size, shuffle, seed=self.seed,
                                       epoch=self._epoch,
                                       drop_remainder=True):
            pending.append(self._train_step(x, y))
            self._py_step += 1
            if len(pending) >= summary_interval:
                flush()
        flush()
        return float(np.mean(losses)) if losses else float("nan")

    def evaluate(self, data, batch_size: int = 32, feature_cols=None,
                 label_cols=None) -> Dict[str, float]:
        """(ref orca/learn/tf/estimator.py evaluate:656) The mean loss and
        each metric over every row; the padded rows of the final batch are
        masked out."""
        ds = self._dataset(data, feature_cols, label_cols)
        states = [m.init_state(self.device) for m in self.metrics]
        sums, counts = [], []
        self.model.train(False)
        with torch.inference_mode():
            for x, y, mask in ds.iter_batches(batch_size,
                                              drop_remainder=False):
                preds = self._forward(self._tensors(x), train=False)
                y = self._tensors(y)
                per = self.loss_fn(y, preds)
                m = torch.ones_like(per) if mask is None else \
                    as_tensor(mask, self.device)
                sums.append((per * m).sum())
                counts.append(m.sum())
                mt = None if mask is None else m
                states = [metric.update(s, y, preds, mt)
                          for metric, s in zip(self.metrics, states)]
        loss_sum = float(torch.stack(sums).double().sum())
        count = float(torch.stack(counts).double().sum())
        out = {"loss": loss_sum / max(count, 1.0)}
        for metric, s in zip(self.metrics, states):
            out[metric.name] = metric.result(s)
        return out

    def predict(self, data, batch_size: int = 32, feature_cols=None):
        """(ref estimator.py predict:598-654) The model's outputs for every
        row, as numpy (a tuple of arrays for a model with several); given
        XShards, ``HostXShards([{"prediction": outputs}])``."""
        was_shards = isinstance(data, XShards)
        if isinstance(data, tuple):
            # predict takes features only: a tuple is a multi-input x
            data = {"x": data}
        ds = self._dataset(data, feature_cols, None)
        if ds.n == 0:
            raise ValueError("predict called on an empty dataset")
        outs = []
        self.model.train(False)
        with torch.inference_mode():
            for x, _, mask in ds.iter_batches(batch_size,
                                              drop_remainder=False):
                preds = to_numpy(self._forward(self._tensors(x),
                                               train=False))
                if mask is not None:
                    valid = int(mask.sum())
                    preds = tree_map(lambda a: a[:valid], preds)
                outs.append(preds)
        if isinstance(outs[0], tuple):
            merged = tuple(np.concatenate([o[i] for o in outs])
                           for i in range(len(outs[0])))
        else:
            merged = np.concatenate(outs)
        if was_shards:
            return HostXShards([{"prediction": merged}])
        return merged

    # ------------- persistence -------------------------------------------
    def save(self, path: str) -> str:
        """Weights, optimizer state and counters into ``path/estimator.pt``
        (ref spark_estimator.save)."""
        os.makedirs(path, exist_ok=True)
        torch.save({"model": self.model.state_dict(),
                    "opt_state": self._ensure_opt_state(),
                    "step": self._py_step, "epoch": self._epoch},
                   os.path.join(path, CHECKPOINT))
        return path

    def load(self, path: str) -> "TorchEstimator":
        """Restore what ``save`` wrote (``path`` is its directory or the
        file)."""
        if os.path.isdir(path):
            path = os.path.join(path, CHECKPOINT)
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        self._opt_state = ckpt["opt_state"]
        self._py_step = int(ckpt["step"])
        self._epoch = int(ckpt["epoch"])
        return self

    def get_model(self) -> nn.Module:
        """The trained module (ref spark_estimator.get_model)."""
        return self.model
