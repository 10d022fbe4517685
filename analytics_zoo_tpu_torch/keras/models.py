"""Sequential / Model topologies with predict and weight persistence.

Counterpart of ``analytics_zoo_tpu/keras/models.py`` (``KerasNet``,
``Model``, ``Sequential``). A built model is one ``GraphModule``
(engine.py), made once from the graph with layer names canonicalized
exactly as the JAX package does, so the same architecture gets the same
parameter names in both packages. Training (``compile``/``fit``/
``evaluate``) waits for a later slice; this slice serves.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.device import (DeviceLike, as_tensor,
                                                   resolve_device, to_numpy)
from analytics_zoo_tpu_torch.keras.engine import (GraphModule, Input,
                                                  KerasLayer, Node, topo_sort)


class KerasNet:
    """Shared predict/persistence surface (ref Topology.scala KerasNet).

    ``seed`` seeds the ``torch.Generator`` the parameters are drawn from
    when the module is first built."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._module: Optional[GraphModule] = None

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

    # -- inference --
    def predict(self, x, batch_size: int = 256,
                device: DeviceLike = None) -> np.ndarray:
        """Forward ``x`` (ndarray, or a tuple of them for a multi-input
        model) in chunks of ``batch_size`` on ``device`` (default
        ``cuda``); the module moves there."""
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

    # -- persistence: torch.save of the state dict --
    def save_weights(self, path: str):
        torch.save(self.module.state_dict(), path)

    def load_weights(self, path: str):
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.module.load_state_dict(state)


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
