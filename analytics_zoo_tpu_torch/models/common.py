"""ZooModel base (ref ``zoo/.../models/common/ZooModel.scala:154``):
a prebuilt Keras-graph model with compile/fit/evaluate/predict plus
save/load, delegated to its ``KerasNet``.

Counterpart of ``analytics_zoo_tpu/models/common.py``. ``save_model``
writes the JAX package's layout: ``config.json`` (the class and its
constructor arguments) and ``weights/ckpt-<step>/`` (``save_weights``,
learn/checkpoint.py), so a model saved by either package loads in the
other.
"""

from __future__ import annotations

import json
import os

from analytics_zoo_tpu_torch.common.device import DeviceLike


class ZooModel:
    """Wraps a built ``analytics_zoo_tpu_torch.keras.models.KerasNet``."""

    def __init__(self):
        self.model = None  # subclasses set in build_model()

    # the training surface delegates to the inner KerasNet
    def compile(self, optimizer, loss, metrics=None,
                device: DeviceLike = None):
        return self.model.compile(optimizer, loss, metrics, device=device)

    def fit(self, *args, **kwargs):
        return self.model.fit(*args, **kwargs)

    def evaluate(self, *args, **kwargs):
        return self.model.evaluate(*args, **kwargs)

    def predict(self, *args, **kwargs):
        """``KerasNet.predict(x, batch_size, distributed, device)``."""
        return self.model.predict(*args, **kwargs)

    def set_strategy(self, strategy, param_rules=None):
        """Only ``"dp"`` (one device)."""
        return self.model.set_strategy(strategy, param_rules)

    def summary(self):
        return self.model.summary()

    def set_tensorboard(self, log_dir, app_name):
        self.model.set_tensorboard(log_dir, app_name)

    def set_checkpoint(self, path):
        self.model.set_checkpoint(path)

    # -- persistence (ref ZooModel.saveModel / load_model) --
    def _config(self) -> dict:
        raise NotImplementedError

    def save_model(self, path: str, over_write: bool = False):
        os.makedirs(path, exist_ok=True)
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path) and not over_write:
            raise FileExistsError(f"{cfg_path} exists; pass over_write=True")
        with open(cfg_path, "w") as fh:
            json.dump({"class": type(self).__name__, **self._config()}, fh)
        self.model.save_weights(os.path.join(path, "weights"))

    @classmethod
    def load_model(cls, path: str) -> "ZooModel":
        with open(os.path.join(path, "config.json")) as fh:
            cfg = json.load(fh)
        klass = cfg.pop("class")
        obj = registry.get(klass)(**cfg)
        obj.model.load_weights(os.path.join(path, "weights"))
        return obj


class _Registry:
    def __init__(self):
        self._classes = {}

    def register(self, cls):
        self._classes[cls.__name__] = cls
        return cls

    def get(self, name: str):
        if name not in self._classes:
            raise KeyError(f"unknown ZooModel class {name!r}; "
                           f"known: {sorted(self._classes)}")
        return self._classes[name]


registry = _Registry()
