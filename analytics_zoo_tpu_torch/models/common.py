"""ZooModel base (ref ``zoo/.../models/common/ZooModel.scala:154``):
a prebuilt Keras-graph model with predict plus save/load.

Counterpart of ``analytics_zoo_tpu/models/common.py``. ``save_model``
writes the port's own format: ``config.json`` (the class and its
constructor arguments, as the JAX package writes it) and ``weights.pt``,
``torch.save`` of the module's state dict.
"""

from __future__ import annotations

import json
import os

from analytics_zoo_tpu_torch.common.device import DeviceLike

WEIGHTS_FILE = "weights.pt"


class ZooModel:
    """Wraps a built ``analytics_zoo_tpu_torch.keras.models.KerasNet``."""

    def __init__(self):
        self.model = None  # subclasses set in build_model()

    def predict(self, x, batch_size: int = 256, device: DeviceLike = None):
        return self.model.predict(x, batch_size=batch_size, device=device)

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
        self.model.save_weights(os.path.join(path, WEIGHTS_FILE))

    @classmethod
    def load_model(cls, path: str) -> "ZooModel":
        with open(os.path.join(path, "config.json")) as fh:
            cfg = json.load(fh)
        klass = cfg.pop("class")
        obj = registry.get(klass)(**cfg)
        obj.model.load_weights(os.path.join(path, WEIGHTS_FILE))
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
