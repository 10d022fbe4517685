"""HuggingFace-format BERT weights into the port, with no JAX.

Counterpart of ``analytics_zoo_tpu/text/hf_import.py``
(``hf_bert_params``). A ``transformers`` ``BertModel`` state dict (or a
``BertFor*`` one, keys under ``bert.``) becomes the ``state_dict`` of the
port's ``BertModule`` directly. Both sides keep ``nn.Linear``'s
``[out, in]`` layout, so nothing is transposed: q/k/v and the attention
output map onto ``attention.{query,key,value,out}``, LayerNorms onto the
flax-named norms, embeddings onto ``*.embedding``. This is how real BERT
checkpoints reach the port.

``load_hf_bert(task, state_dict_or_path)`` (JAX ``load_hf_bert``) loads
them into a BERT task estimator's encoder in place: every shape is
checked first (``_validate_like``: a name the model lacks is a
``KeyError``, another shape a ``ValueError`` ending "(config
mismatch?)", as in JAX; the paths name the port's ``state_dict``
leaves); the task head keeps its weights; the optimizer state, the step
and the epoch start afresh, as the JAX estimator's do when it drops its
state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from analytics_zoo_tpu_torch.convert import nest
from analytics_zoo_tpu_torch.text.bert import BertConfig


def _strip_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Accept BertModel dicts and BertFor* dicts (keys under 'bert.')."""
    if any(k.startswith("bert.") for k in sd):
        return {k[len("bert."):]: v for k, v in sd.items()
                if k.startswith("bert.")}
    return sd


def hf_bert_params(state_dict_or_model, config: BertConfig
                   ) -> Dict[str, torch.Tensor]:
    """transformers ``BertModel`` weights -> ``BertModule.state_dict()``
    (fp32 tensors on the CPU)."""
    sd = state_dict_or_model
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = _strip_prefix(dict(sd))
    names = {
        "word_embeddings.embedding": "embeddings.word_embeddings.weight",
        "position_embeddings.embedding":
            "embeddings.position_embeddings.weight",
        "token_type_embeddings.embedding":
            "embeddings.token_type_embeddings.weight",
        "embed_norm": "embeddings.LayerNorm",
        "pooler": "pooler.dense",
    }
    for i in range(config.n_block):
        p = f"encoder.layer.{i}"
        names.update({
            f"block_{i}.attention.query": f"{p}.attention.self.query",
            f"block_{i}.attention.key": f"{p}.attention.self.key",
            f"block_{i}.attention.value": f"{p}.attention.self.value",
            f"block_{i}.attention.out": f"{p}.attention.output.dense",
            f"block_{i}.attn_norm": f"{p}.attention.output.LayerNorm",
            f"block_{i}.intermediate": f"{p}.intermediate.dense",
            f"block_{i}.output": f"{p}.output.dense",
            f"block_{i}.ffn_norm": f"{p}.output.LayerNorm",
        })
    out = {}
    for ours, theirs in names.items():
        pairs = [(ours, theirs)] if ours.endswith(".embedding") else \
            [(f"{ours}.{leaf}", f"{theirs}.{leaf}")
             for leaf in ("weight", "bias")]
        for key, src in pairs:
            # .float() first: bf16 checkpoints are common
            out[key] = sd[src].detach().cpu().float().clone()
    return out


def _validate_like(new: Mapping, ref: Mapping, path: str = "bert") -> None:
    """Every leaf of the tree ``new`` is in ``ref`` with its shape."""
    for k, v in new.items():
        if k not in ref:
            raise KeyError(f"{path}/{k} not in the model's parameter tree "
                           f"(have {sorted(ref)})")
        if isinstance(v, Mapping):
            _validate_like(v, ref[k], f"{path}/{k}")
        elif tuple(v.shape) != tuple(ref[k].shape):
            raise ValueError(f"{path}/{k}: checkpoint shape "
                             f"{tuple(v.shape)} != model "
                             f"{tuple(ref[k].shape)} (config mismatch?)")


def load_hf_bert(estimator, state_dict_or_path,
                 bert_key: str = "bert") -> None:
    """Load HuggingFace BERT weights into the encoder of a
    ``_BertTaskEstimator`` (``estimator``), in place on its device. The
    task head keeps its weights (the fine-tuning flow); the optimizer
    state, the step and the epoch restart."""
    sd = state_dict_or_path
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    est = estimator.estimator
    model = est.model
    children = dict(model.named_children())
    if bert_key not in children:
        raise KeyError(f"{bert_key!r} not in the estimator's parameter "
                       f"tree (have {sorted(children)})")
    target = children[bert_key].state_dict(keep_vars=True)
    new = hf_bert_params(sd, estimator.config)
    _validate_like(nest(new), nest(target), bert_key)
    with torch.no_grad():
        for key, val in new.items():
            target[key].copy_(val)
    # JAX drops its device state here, which restarts the step at 0: the
    # host mirrors (the dropout seed, the snapshots' step) follow
    est._opt_state = None
    est._py_step = 0
    est._epoch = 0
