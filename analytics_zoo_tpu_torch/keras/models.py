"""Sequential / Model topologies with compile/fit/evaluate/predict and
weight persistence.

Counterpart of ``analytics_zoo_tpu/keras/models.py`` (``KerasNet``,
``Model``, ``Sequential``). A built model is one ``GraphModule``
(engine.py), made once from the graph with layer names canonicalized
exactly as the JAX package does, so the same architecture gets the same
parameter names in both packages. Training delegates to the port's
``TorchEstimator`` (learn/estimator.py), as the JAX package delegates to
its estimator: ``compile(optimizer, loss, metrics, device=None)`` picks
the device (``cuda`` unless ``device="cpu"``), and ``fit`` / ``evaluate``
/ ``predict`` run there. The estimator trains the model's own module, so
weights loaded before ``compile`` (or a second ``compile``) are kept.

The layers' weight regularizers (``Dense(W_regularizer=...)``) add up
into one penalty on the training loss (``_param_penalty_fn``);
``set_tensorboard`` names where the estimator writes its summaries;
``summary()`` prints the JAX package's table, name for name.

Persistence is the JAX package's: ``save_weights``/``load_weights`` go
through the estimator's ``save``/``load`` (``<path>/ckpt-<step>/``, flax's
tree, learn/checkpoint.py), so weights written by either package load in
the other; an uncompiled model saves and loads against the adam/mse
defaults, optimizer state included, as in JAX. ``set_checkpoint`` sets
the estimator's ``model_dir``. ``save``/``load`` add the pickled topology
(``topology.pkl``) beside ``weights/``; only the port reads the port's
pickle (its layers are PyTorch objects).
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.device import (DeviceLike, as_tensor,
                                                   resolve_device, to_numpy)
from analytics_zoo_tpu_torch.convert import (flatten, flax_layout,
                                             flax_leaves, nest)
from analytics_zoo_tpu_torch.keras.engine import (GraphModule, Input,
                                                  KerasLayer, Node, topo_sort)


def _registry_names():
    """Callables a layer may hold that pickle by name: the activations
    and the init functions (module-level lambdas among them)."""
    from analytics_zoo_tpu_torch.keras.layers import _ACTIVATIONS, _INITS
    names = {id(fn): ("activation", name)
             for name, fn in _ACTIVATIONS.items()}
    names.update({id(fn): ("init", name) for name, fn in _INITS.items()})
    return names


class _TopologyPickler(pickle.Pickler):
    """Reduces the registry callables layers hold (activations, inits) to
    their names; everything else pickles normally (a ``Lambda`` needs a
    named, importable function)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._names = _registry_names()

    def persistent_id(self, obj):
        if callable(obj) and not isinstance(obj, type):
            return self._names.get(id(obj))
        return None


class _TopologyUnpickler(pickle.Unpickler):
    def persistent_load(self, pid):
        from analytics_zoo_tpu_torch.keras.layers import (get_activation,
                                                          get_init)
        kind, name = pid
        if kind == "activation":
            return get_activation(name)
        if kind == "init":
            return get_init(name)
        raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")


class KerasNet:
    """Shared compile/fit/predict/persistence surface (ref Topology.scala
    KerasNet).

    ``seed`` seeds the ``torch.Generator`` the parameters are drawn from
    when the module is first built."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._module: Optional[GraphModule] = None
        self._estimator = None
        self._compile_args: Optional[dict] = None
        self._strategy = "dp"
        self._param_rules = None
        self.model_dir: Optional[str] = None
        self._tensorboard: Optional[Tuple[str, str]] = None

    # -- to be provided by subclass --
    def _graph(self) -> Tuple[List[Node], List[Node]]:
        raise NotImplementedError

    def input_shapes(self) -> List[Tuple]:
        inputs, _ = self._graph()
        shapes = [n.shape for n in inputs]
        if any(s is None for s in shapes):
            raise ValueError("input shapes unknown; give input_shape to the "
                             "first layer or use Input()")
        return shapes

    def to_torch(self) -> GraphModule:
        """A fresh ``GraphModule`` of this graph, parameters drawn from
        ``seed``."""
        inputs, outputs = self._graph()
        order = tuple(topo_sort(outputs))
        self._canonicalize_names(order)
        return GraphModule(graph_inputs=tuple(n.id for n in inputs),
                           graph_outputs=tuple(n.id for n in outputs),
                           order=order, seed=self.seed)

    @property
    def module(self) -> GraphModule:
        """The model's module, built on first use (on the CPU)."""
        if self._module is None:
            self._module = self.to_torch()
        return self._module

    @staticmethod
    def _canonicalize_names(order):
        """Auto-generated layer names are rewritten to a deterministic
        per-model scheme (type_index in topo order) so two builds of the same
        architecture produce identical parameter trees — required for
        checkpoint/save_model round-trips across processes. Canonical names
        never collide with user-chosen names (the graph executor memoizes
        submodules by name, so a collision would silently run the wrong
        layer), and duplicate user names are rejected."""
        layers, user_names = [], set()
        seen: set = set()
        for node in order:
            layer = node.layer
            if layer is None or id(layer) in seen:
                continue
            seen.add(id(layer))
            layers.append(layer)
            if not getattr(layer, "_auto_named", False):
                if layer.name in user_names:
                    raise ValueError(
                        f"duplicate layer name {layer.name!r}; layer names "
                        "must be unique within a model")
                user_names.add(layer.name)
        counters: dict = {}
        for layer in layers:
            if getattr(layer, "_auto_named", False):
                prefix = type(layer).__name__.lower()
                while True:
                    counters[prefix] = counters.get(prefix, 0) + 1
                    cand = f"{prefix}_{counters[prefix]}"
                    if cand not in user_names:
                        break
                layer.name = cand

    def sample_input(self, batch: int = 2):
        shapes = self.input_shapes()
        arrs = tuple(np.zeros((batch,) + tuple(s), np.float32)
                     for s in shapes)
        return arrs[0] if len(arrs) == 1 else arrs

    # -- training (ref Topology.scala compile:139, fit:347) --
    def compile(self, optimizer, loss, metrics: Optional[List] = None,
                device: DeviceLike = None) -> "KerasNet":
        """Set the optimizer (an ``Optimizer`` or a name), the loss and
        the metrics (keras names: ``"accuracy"``, ...). ``device`` is the
        port's addition: where ``fit``/``evaluate``/``predict`` run
        (default ``cuda``, which raises without CUDA; the tests pass
        ``"cpu"``). Compiling keeps the current parameters (loaded weights,
        earlier training) and starts a fresh optimizer state."""
        self._compile_args = dict(optimizer=optimizer, loss=loss,
                                  metrics=metrics, device=device)
        self._estimator = None
        return self

    def set_strategy(self, strategy: str, param_rules=None) -> "KerasNet":
        """Parallelism for this model ("dp", "dp2,tp4", ...;
        ``parallel/strategy.py``). ``param_rules=None`` keeps the rules
        set before. Parameters (loaded weights, training) are kept, as in
        JAX: the estimator built next shards them under the new layout."""
        self._strategy = strategy
        if param_rules is not None:
            self._param_rules = param_rules
        self._estimator = None
        return self

    def _ensure_estimator(self, for_training: bool = False):
        if self._estimator is None:
            args = self._compile_args
            if args is None:
                if for_training:
                    raise RuntimeError(
                        "call compile(optimizer, loss) before fit/evaluate")
                # weights-only use before compile is legal, as in JAX
                args = dict(optimizer="adam", loss="mse", metrics=None,
                            device=None)
            from analytics_zoo_tpu_torch.learn.estimator import (
                TorchEstimator,
            )
            self._estimator = TorchEstimator(
                self.module, loss=args["loss"], optimizer=args["optimizer"],
                metrics=args["metrics"], model_dir=self.model_dir,
                strategy=self._strategy,
                # (a model pickled before set_strategy kept rules has no
                # _param_rules)
                param_rules=getattr(self, "_param_rules", None),
                device=args["device"],
                param_penalty=self._param_penalty_fn())
            # (a model pickled before set_tensorboard existed has no
            # _tensorboard)
            if getattr(self, "_tensorboard", None) is not None:
                self._estimator.set_tensorboard(*self._tensorboard)
        return self._estimator

    def _param_penalty_fn(self):
        """The layers' W/b regularizers as one ``{parameter name: tensor}
        -> scalar`` penalty for the train step, summed layer by layer in
        topological order as the JAX package sums them (its
        keras/models.py ``_param_penalty_fn``); None when no layer
        regularizes."""
        module = self.module
        pairs, seen = [], set()
        for node in module.order:
            layer = node.layer
            if layer is None or id(layer) in seen:
                continue
            seen.add(id(layer))
            if not getattr(layer, "param_regularizers", None):
                continue
            # flax leaf -> torch parameter name, over the layer's modules
            names = {}
            for key in module._layer_keys.get(layer.name, ()):
                mod = module._modules[key]
                direct = dict(mod.named_parameters(recurse=False))
                for fleaf, (tleaf, _) in (flax_leaves(mod, direct)
                                          or {}).items():
                    names[fleaf] = f"{key}.{tleaf}"
            pairs.append((layer, names))
        if not pairs:
            return None

        def penalty(params):
            total = 0.0
            for layer, names in pairs:
                total += layer.penalty({f: params[n] for f, n in names.items()
                                        if n in params})
            return total

        return penalty

    def _weights_estimator(self):
        """The estimator ``save_weights``/``load_weights`` go through: the
        model's own once there is one, else one with the adam/mse defaults
        on the device the module is on (JAX builds the same defaults; a
        later ``compile`` starts a fresh optimizer state either way)."""
        if self._compile_args is not None or self._estimator is not None:
            return self._ensure_estimator()
        from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator
        param = next(self.module.parameters(), None)
        device = param.device if param is not None else "cpu"
        return TorchEstimator(self.module, loss="mse", optimizer="adam",
                              device=device)

    @property
    def estimator(self):
        """The training engine (built with adam/mse defaults if the model
        is not compiled, as in JAX)."""
        return self._ensure_estimator()

    def set_constant_gradient_clipping(self, min_value, max_value):
        self._ensure_estimator().set_constant_gradient_clipping(min_value,
                                                                max_value)

    def set_gradient_clipping_by_l2_norm(self, clip_norm):
        self._ensure_estimator().set_l2_norm_gradient_clipping(clip_norm)

    def set_tensorboard(self, log_dir: str, app_name: str):
        """Write the training and validation summaries under
        ``<log_dir>/<app_name>/{train,validation}`` (kept across a later
        ``compile``)."""
        self._tensorboard = (log_dir, app_name)
        if self._estimator is not None:
            self._estimator.set_tensorboard(log_dir, app_name)

    def set_checkpoint(self, path: str):
        """Snapshot into ``path`` during ``fit`` (the estimator's
        ``model_dir``; kept across a later ``compile``)."""
        self.model_dir = path
        if self._estimator is not None:
            self._estimator.model_dir = path

    @staticmethod
    def _as_x(x):
        return tuple(x) if isinstance(x, (list, tuple)) else x

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None, distributed: bool = True, shuffle=True,
            feature_cols=None, label_cols=None, **kwargs):
        """(ref Topology.scala fit:347; py keras fit(x, y, batch_size,
        nb_epoch, validation_data)). ``x`` is an array, a list of arrays
        for a multi-input model, or XShards / a DataFrame with
        ``feature_cols``; returns ``{"loss": [...], "val_<metric>": [...]}``
        with one value per epoch."""
        est = self._ensure_estimator(for_training=True)
        data = self._as_x(x) if y is None else (self._as_x(x), y)
        if isinstance(validation_data, tuple) and len(validation_data) == 2:
            validation_data = (self._as_x(validation_data[0]),
                               validation_data[1])
        return est.fit(data, epochs=nb_epoch, batch_size=batch_size,
                       validation_data=validation_data, shuffle=shuffle,
                       feature_cols=feature_cols, label_cols=label_cols,
                       **kwargs)

    def evaluate(self, x, y=None, batch_size: int = 32, **kwargs):
        """The mean loss and each compiled metric over every row."""
        est = self._ensure_estimator(for_training=True)
        data = self._as_x(x) if y is None else (self._as_x(x), y)
        return est.evaluate(data, batch_size=batch_size, **kwargs)

    # -- inference --
    def predict(self, x, batch_size: int = 256, distributed: bool = True,
                device: DeviceLike = None) -> np.ndarray:
        """Forward ``x`` (ndarray, or a list or tuple of them for a
        multi-input model) in chunks of ``batch_size``. Once compiled,
        through the estimator on the compiled device (``device``, if
        given, must be it); before, on ``device`` (default ``cuda``), to
        which the module moves."""
        if self._compile_args is not None or self._estimator is not None:
            est = self._ensure_estimator()
            if device is not None and resolve_device(device) != est.device:
                raise ValueError(f"the model is compiled for {est.device}, "
                                 f"not {device}")
            return est.predict(self._as_x(x), batch_size=batch_size)
        dev = resolve_device(device)
        module = self.module.to(dev).eval()
        xs = tuple(x) if isinstance(x, (list, tuple)) else (x,)
        n = int(np.shape(xs[0])[0])
        if n == 0:
            raise ValueError("predict called on an empty batch")
        outs = []
        with torch.inference_mode():
            for lo in range(0, n, int(batch_size)):
                chunk = [as_tensor(np.asarray(a)[lo:lo + int(batch_size)],
                                   dev) for a in xs]
                outs.append(to_numpy(module(*chunk)))
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(parts) for parts in zip(*outs))
        return np.concatenate(outs)

    def predict_classes(self, x, batch_size: int = 256,
                        zero_based_label: bool = True,
                        device: DeviceLike = None) -> np.ndarray:
        """(ref pyzoo keras predict_classes)"""
        probs = self.predict(x, batch_size=batch_size, device=device)
        classes = np.argmax(np.asarray(probs), axis=-1)
        return classes if zero_based_label else classes + 1

    # -- persistence (the JAX layout, through the estimator) --
    def save_weights(self, path: str):
        """Parameters and optimizer state into ``path/ckpt-<step>/``."""
        self._weights_estimator().save(path)

    def load_weights(self, path: str):
        """Load what ``save_weights`` (of either package) wrote into the
        module in place, on whatever device it is: a compiled model
        trains on from the loaded weights and optimizer state."""
        self._weights_estimator().load(path)

    def get_weights(self) -> dict:
        """A copy of the parameters as ``{"<layer>.<leaf>": ndarray}`` (the
        JAX package returns its flax tree; ``convert.state_dict_to_flax``
        maps between the two)."""
        return {k: to_numpy(v).copy()
                for k, v in self.module.state_dict().items()}

    def save(self, path: str) -> str:
        """The whole model (ref Topology.scala saveModule): the pickled
        topology (layers, compile settings) in ``topology.pkl`` and the
        weights in ``weights/``. Only the port reads the port's pickle."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "topology.pkl"), "wb") as fh:
            _TopologyPickler(fh, protocol=pickle.HIGHEST_PROTOCOL).dump(self)
        self.save_weights(os.path.join(path, "weights"))
        return path

    @staticmethod
    def load(path: str) -> "KerasNet":
        """(ref Net.load for keras models) A model ``save`` wrote, with
        its weights and, if it was compiled, its optimizer state.
        Unpickling runs code: load only what you saved yourself."""
        with open(os.path.join(path, "topology.pkl"), "rb") as fh:
            model = _TopologyUnpickler(fh).load()
        model.load_weights(os.path.join(path, "weights"))
        return model

    def __getstate__(self):
        # topology and settings only: the module and the estimator are
        # rebuilt on load, and the weights travel in weights/
        state = dict(self.__dict__)
        state["_estimator"] = None
        state["_module"] = None
        return state

    def summary(self) -> str:
        """(ref Topology.scala summary) Prints and returns the parameter
        count of each top-level name of the flax tree and the total: the
        JAX package's text for the same model."""
        module = self.module
        tree = flax_layout(module)
        if tree is None:
            tree = nest({n: p for n, p in module.named_parameters()})
        total = 0
        lines = ["_" * 64, f"{'Layer (type)':<34}{'Param #':>12}", "=" * 64]
        for name, sub in tree.items():
            leaves = [sub] if isinstance(sub, torch.Tensor) else \
                flatten(sub).values()
            n = sum(int(np.prod(t.shape)) for t in leaves)
            total += n
            lines.append(f"{name:<34}{n:>12,}")
        lines.append("=" * 64)
        lines.append(f"Total params: {total:,}")
        text = "\n".join(lines)
        print(text)
        return text


class Sequential(KerasNet):
    """(ref Topology.scala Sequential:854; py Sequential().add(...))"""

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self.layers: List[KerasLayer] = []
        self._built: Optional[Tuple[List[Node], List[Node]]] = None

    def add(self, layer: KerasLayer) -> "Sequential":
        if not isinstance(layer, KerasLayer):
            raise TypeError(f"cannot add {type(layer)}")
        self.layers.append(layer)
        self._built = None
        self._module = None
        return self

    def _graph(self):
        if self._built is None:
            if not self.layers:
                raise ValueError("empty Sequential")
            in_shape = getattr(self.layers[0], "input_shape", None)
            if in_shape is None:
                raise ValueError(
                    "first layer of a Sequential needs input_shape=...")
            node = Input(shape=in_shape)
            inputs = [node]
            for layer in self.layers:
                node = layer(node)
            self._built = (inputs, [node])
        return self._built


class Model(KerasNet):
    """Functional graph model (ref Topology.scala Model:631;
    py Model(input=..., output=...))."""

    def __init__(self, input, output, seed: int = 0):
        super().__init__(seed)
        self._inputs = input if isinstance(input, (list, tuple)) else [input]
        self._outputs = output if isinstance(output, (list, tuple)) \
            else [output]
        for n in list(self._inputs) + list(self._outputs):
            if not isinstance(n, Node):
                raise TypeError("Model(input=, output=) takes Input()/layer "
                                "nodes")

    def _graph(self):
        return list(self._inputs), list(self._outputs)
