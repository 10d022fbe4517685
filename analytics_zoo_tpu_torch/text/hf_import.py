"""HuggingFace-format BERT weights into the port, with no JAX.

Counterpart of ``analytics_zoo_tpu/text/hf_import.py``
(``hf_bert_params``). A ``transformers`` ``BertModel`` state dict (or a
``BertFor*`` one, keys under ``bert.``) becomes the ``state_dict`` of the
port's ``BertModule`` directly. Both sides keep ``nn.Linear``'s
``[out, in]`` layout, so nothing is transposed: q/k/v and the attention
output map onto ``attention.{query,key,value,out}``, LayerNorms onto the
flax-named norms, embeddings onto ``*.embedding``. This is how real BERT
checkpoints reach the port.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

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
