"""Pretrained-weight migration for the model zoo, the port's copy.

Counterpart of ``analytics_zoo_tpu/models/migration.py`` (ref
``Net.scala:446`` loads downloadable BigDL artifacts, a format dead
outside Spark): a reference model's weights are re-expressed in torch
(the twins below define the ``state_dict`` contract, architecture for
architecture the zoo model's) and imported into the zoo model.

- ``assign_layer_params(net, updates, state_updates)`` writes flax-layout
  arrays (``{layer: {"kernel" | "bias" | "scale" | "embedding": array}}``
  and ``{layer: {"mean" | "var": array}}`` for the running statistics)
  into a built keras model of the port, through ``convert.py``'s layout
  rules, shapes checked against the model's flax tree;
- the NeuralCF, Wide&Deep and (cnn) TextClassifier twins and
  importers, as in JAX.

The image twins and importer are ``models/migration_image.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t, np.float32)


def assign_layer_params(net, updates: Dict[str, Dict[str, np.ndarray]],
                        state_updates: Dict[str, Dict[str, np.ndarray]]
                        = None):
    """Overwrite named entries of a keras model's parameters, in place.

    ``updates``: ``{layer name: {flax leaf: array}}`` in the flax layout
    (a Dense kernel ``[in, out]``, a convolution's ``[*k, in / groups,
    out]``); layer names are the model's canonical names. Shapes must
    equal the model's flax tree's (``ValueError`` otherwise; an unknown
    layer or leaf is a ``KeyError``).

    ``state_updates``: the same for the ``batch_stats`` collection
    (``"mean"`` / ``"var"``), where pretrained running statistics land.
    Every array is checked before any is written.
    """
    from analytics_zoo_tpu_torch.convert import (flatten, flax_layout,
                                                 flax_to_state_dict)
    module = net.module
    like = flax_layout(module)
    if like is None:
        raise ValueError("the model has parameters outside the flax layout")
    writes: Dict[str, np.ndarray] = {}
    for lname, entries in updates.items():
        if lname not in like:
            raise KeyError(
                f"layer {lname!r} not in model (have {sorted(like)})")
        leaves = flatten(like[lname])
        arrays = {}
        for key, arr in entries.items():
            if key not in leaves:
                raise KeyError(f"{lname} has no param {key!r} "
                               f"(have {sorted(leaves)})")
            arr = np.asarray(arr, np.float32)
            cur = tuple(leaves[key].shape)
            if cur != arr.shape:
                raise ValueError(
                    f"{lname}/{key}: shape {arr.shape} != model {cur}")
            arrays[key] = arr
        sub = {}
        for key, arr in arrays.items():
            node = sub
            *path, leaf = key.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = arr
        writes.update(flax_to_state_dict({lname: sub}))
    buffers = dict(module.named_buffers())
    for lname, entries in (state_updates or {}).items():
        for key, arr in entries.items():
            name = f"{lname}.{key}"
            if name not in buffers:
                raise KeyError(f"layer {lname!r} has no batch_stats {key!r}")
            arr = np.asarray(arr, np.float32)
            cur = tuple(buffers[name].shape)
            if cur != arr.shape:
                raise ValueError(f"{lname}/batch_stats/{key}: shape "
                                 f"{arr.shape} != model {cur}")
            writes[name] = torch.from_numpy(np.ascontiguousarray(arr))
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, val in writes.items():
            dst = params[name] if name in params else buffers[name]
            dst.copy_(val.to(dst.dtype))
    return net


def _state_dict(torch_model_or_state):
    if isinstance(torch_model_or_state, dict):
        return torch_model_or_state
    return torch_model_or_state.state_dict()


def _linear(sd, prefix):
    """torch ``nn.Linear`` ``[out, in]`` as a flax Dense kernel ``[in,
    out]`` and its bias."""
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


# --------------------------------------------------------------- NCF ----

def make_torch_ncf(user_count: int, item_count: int, class_num: int,
                   user_embed: int = 20, item_embed: int = 20,
                   hidden_layers=(40, 20, 10), include_mf: bool = True,
                   mf_embed: int = 20):
    """Torch twin of the reference NeuralCF
    (ref pyzoo/zoo/models/recommendation/neuralcf.py:70-96): embeddings
    sized count+1 (1-based ids), MLP tower over concatenated user/item
    embeddings, optional GMF branch, softmax head. state_dict keys:
    ``mlp_user_embed.weight``, ``mlp_item_embed.weight``,
    ``fc.{i}.weight/bias``, ``mf_user_embed.weight``,
    ``mf_item_embed.weight``, ``head.weight/bias``."""
    import torch.nn as nn

    class TorchNeuralCF(nn.Module):
        def __init__(self):
            super().__init__()
            self.include_mf = include_mf
            self.mlp_user_embed = nn.Embedding(user_count + 1, user_embed)
            self.mlp_item_embed = nn.Embedding(item_count + 1, item_embed)
            dims = [user_embed + item_embed] + list(hidden_layers)
            self.fc = nn.ModuleList(
                [nn.Linear(dims[i], dims[i + 1])
                 for i in range(len(hidden_layers))])
            head_in = hidden_layers[-1]
            if include_mf:
                self.mf_user_embed = nn.Embedding(user_count + 1, mf_embed)
                self.mf_item_embed = nn.Embedding(item_count + 1, mf_embed)
                head_in += mf_embed
            self.head = nn.Linear(head_in, class_num)

        def forward(self, x):           # x: [b, 2] (user, item) ids
            u, i = x[:, 0].long(), x[:, 1].long()
            h = torch.cat([self.mlp_user_embed(u),
                           self.mlp_item_embed(i)], dim=1)
            for fc in self.fc:
                h = torch.relu(fc(h))
            if self.include_mf:
                mf = self.mf_user_embed(u) * self.mf_item_embed(i)
                h = torch.cat([h, mf], dim=1)
            return torch.softmax(self.head(h), dim=1)

    return TorchNeuralCF()


def import_ncf_from_torch(zoo_ncf, torch_model_or_state):
    """Load ``make_torch_ncf``-contract weights into a zoo ``NeuralCF``."""
    sd = _state_dict(torch_model_or_state)
    n_hidden = len(zoo_ncf.hidden_layers)
    updates = {
        "mlp_user_embed": {"embedding": _np(sd["mlp_user_embed.weight"])},
        "mlp_item_embed": {"embedding": _np(sd["mlp_item_embed.weight"])},
    }
    for i in range(n_hidden):
        updates[f"dense_{i + 1}"] = _linear(sd, f"fc.{i}")
    if zoo_ncf.include_mf:
        updates["mf_user_embed"] = {
            "embedding": _np(sd["mf_user_embed.weight"])}
        updates["mf_item_embed"] = {
            "embedding": _np(sd["mf_item_embed.weight"])}
    updates[f"dense_{n_hidden + 1}"] = _linear(sd, "head")
    assign_layer_params(zoo_ncf.model, updates)
    return zoo_ncf


# ------------------------------------------------------ Wide & Deep ----

def make_torch_wide_and_deep(class_num: int, column_info,
                             hidden_layers=(40, 20, 10)):
    """Torch twin of the reference WideAndDeep (wide_n_deep flavor,
    ref pyzoo/zoo/models/recommendation/wide_and_deep.py:141-200):
    wide = linear over the sparse wide block; deep = per-column embeddings
    + indicator/continuous concat through an MLP; softmax(wide + deep).
    state_dict keys: ``wide_linear.weight/bias``, ``embed.{i}.weight``,
    ``fc.{i}.weight/bias``, ``head.weight/bias``."""
    import torch.nn as nn

    info = column_info
    wide_dims = sum(info.wide_base_dims) + sum(info.wide_cross_dims)
    deep_in = sum(info.indicator_dims) + sum(info.embed_out_dims) \
        + len(info.continuous_cols)

    class TorchWideAndDeep(nn.Module):
        def __init__(self):
            super().__init__()
            self.wide_linear = nn.Linear(wide_dims, class_num)
            self.embed = nn.ModuleList(
                [nn.Embedding(ind + 1, outd) for ind, outd in
                 zip(info.embed_in_dims, info.embed_out_dims)])
            dims = [deep_in] + list(hidden_layers)
            self.fc = nn.ModuleList(
                [nn.Linear(dims[i], dims[i + 1])
                 for i in range(len(hidden_layers))])
            self.head = nn.Linear(hidden_layers[-1], class_num)

        def forward(self, wide, ind, emb, con):
            w = self.wide_linear(wide)
            embs = [e(emb[:, i].long())
                    for i, e in enumerate(self.embed)]
            h = torch.cat([ind] + embs + [con], dim=1)
            for fc in self.fc:
                h = torch.relu(fc(h))
            d = torch.relu(self.head(h))
            return torch.softmax(w + d, dim=1)

    return TorchWideAndDeep()


def import_wide_and_deep_from_torch(zoo_wnd, torch_model_or_state):
    """Load ``make_torch_wide_and_deep``-contract weights into a zoo
    ``WideAndDeep`` (model_type='wide_n_deep')."""
    sd = _state_dict(torch_model_or_state)
    n_hidden = len(zoo_wnd.hidden_layers)
    updates = {"wide_linear": _linear(sd, "wide_linear")}
    for i in range(len(zoo_wnd.column_info.embed_cols)):
        updates[f"embed_{i}"] = {"embedding": _np(sd[f"embed.{i}.weight"])}
    for i in range(n_hidden):
        updates[f"dense_{i + 1}"] = _linear(sd, f"fc.{i}")
    updates[f"dense_{n_hidden + 1}"] = _linear(sd, "head")
    assign_layer_params(zoo_wnd.model, updates)
    return zoo_wnd


# -------------------------------------------------- Text classifier ----

def make_torch_text_classifier(class_num: int, vocab_size: int,
                               token_length: int = 200,
                               encoder_output_dim: int = 256):
    """Torch twin of the reference TextClassifier with the CNN encoder
    (ref pyzoo/zoo/models/textclassification/text_classifier.py:
    Embedding → Conv1d(k=5) + ReLU → global max pool → Dense(128) →
    softmax head). state_dict keys: ``embed.weight``, ``conv.weight/bias``,
    ``fc.weight/bias``, ``head.weight/bias``."""
    import torch.nn as nn

    class TorchTextClassifier(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab_size + 1, token_length)
            self.conv = nn.Conv1d(token_length, encoder_output_dim, 5)
            self.fc = nn.Linear(encoder_output_dim, 128)
            self.head = nn.Linear(128, class_num)

        def forward(self, ids):        # [b, seq]
            h = self.embed(ids.long()).transpose(1, 2)   # [b, C, seq]
            h = torch.relu(self.conv(h)).max(dim=2).values
            h = torch.relu(self.fc(h))
            return torch.softmax(self.head(h), dim=1)

    return TorchTextClassifier()


def import_text_classifier_from_torch(zoo_tc, torch_model_or_state):
    """Load ``make_torch_text_classifier``-contract weights into a zoo
    ``TextClassifier`` (encoder='cnn'; LSTM/GRU-encoder models migrate via
    ``Estimator.from_torch`` translation instead)."""
    if zoo_tc.encoder != "cnn":
        raise ValueError(
            "torch weight import covers the cnn encoder; for lstm/gru "
            "run the torch model through Estimator.from_torch")
    sd = _state_dict(torch_model_or_state)
    # torch Conv1d weight [out, in, k] → zoo Conv1D kernel [k, in, out]
    conv_k = _np(sd["conv.weight"]).transpose(2, 1, 0)
    updates = {
        "word_embedding": {"embedding": _np(sd["embed.weight"])},
        "conv1d_1": {"kernel": conv_k, "bias": _np(sd["conv.bias"])},
        "dense_1": _linear(sd, "fc"),
        "dense_2": _linear(sd, "head"),
    }
    assign_layer_params(zoo_tc.model, updates)
    return zoo_tc
