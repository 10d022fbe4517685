#!/usr/bin/env python3
"""CPU estimate of how far BERT-Base's gradients through the flash kernels
may sit from those of the einsum chain: the basis of chip_smoke.py's
phase 8 limits.

    python3 dev/estimate_bert_train_limits.py

Builds the BERT-Base classifier of chip_smoke.py (full width, dropout
off, weights from numpy seed 0) cut to 2 and to 4 blocks, and takes one
training step's loss and gradients on 8 x 128 token ids twice: with
``use_flash=True``, where attention runs the forward and backward
kernels' plain versions (``ops/flash_attention.py``'s autograd Function
on the CPU; the kernels sum in another order only), and with
``use_flash=False``, the einsum chain under autograd. fp32, and bf16
compute with fp32 parameters. For each it prints the loss difference
and, over every parameter, the largest gradient difference relative to
that gradient's largest element (for the attention key biases, whose
gradient is zero but for rounding, relative to the model's largest
gradient element; ``chip_smoke.grad_reading``). Runs on the CPU only;
writes nothing.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import grad_reading  # noqa: E402

BATCH, LENGTH = 8, 128


def gradients(torch, np, n_block, use_flash, dtype, ids, labels):
    from analytics_zoo_tpu_torch.learn import losses
    from analytics_zoo_tpu_torch.text import BertConfig, init_bert_weights
    from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule
    cfg = BertConfig(n_block=n_block, hidden_drop=0.0, attn_drop=0.0,
                     use_flash=use_flash, dtype=dtype)
    module = init_bert_weights(_ClassifierModule(cfg, 2), 0)
    loss = losses.get("sparse_categorical_crossentropy_logits")(
        torch.from_numpy(labels), module(torch.from_numpy(ids),
                                         train=True)).mean()
    params = [p for p in module.parameters()]
    grads = torch.autograd.grad(loss, params)
    names = [n for n, _ in module.named_parameters()]
    return float(loss), dict(zip(names, grads))


def main() -> int:
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.ops import attention, flash_attention

    chain = attention.dot_product_attention

    def cpu_flash(q, k, v, mask=None, causal=False, use_flash=None):
        # the kernels' plain versions stand in for the kernels on the CPU
        if use_flash and mask is None:
            return flash_attention.flash_attention(q, k, v, causal=causal)
        return chain(q, k, v, mask=mask, causal=causal, use_flash=False)

    attention.dot_product_attention = cpu_flash
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 30522, (BATCH, LENGTH)).astype(np.int32)
    labels = rng.randint(0, 2, BATCH).astype(np.int32)
    out = {}
    for dtype in (None, torch.bfloat16):
        for n_block in (2, 4):
            lf, gf = gradients(torch, np, n_block, True, dtype, ids, labels)
            lc, gc = gradients(torch, np, n_block, False, dtype, ids, labels)
            rel, worst = grad_reading(gf, gc)
            key = f"{'bf16' if dtype else 'fp32'}_blocks{n_block}"
            out[key] = {"loss_flash": lf, "loss_chain": lc,
                        "loss_diff": abs(lf - lc),
                        "max_rel_grad_diff": rel, "worst_param": worst}
            print(key, json.dumps(out[key]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
