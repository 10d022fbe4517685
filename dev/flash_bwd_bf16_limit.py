#!/usr/bin/env python3
"""How far the bf16 flash-attention backward kernels may sit from their
plain versions, measured on one GPU.

    python3 dev/flash_bwd_bf16_limit.py [--seeds N]

The plain versions (``ops.flash_attention._flash_bwd_dq_ref`` and
``_flash_bwd_dkv_ref``) compute the scores and dP with fp32 matmuls and p
with ``torch.exp``; the bf16 kernels compute them on the tensor cores,
whose fp32 sums of the exact bf16 products round in another order, and p
with ``ex2.approx`` of (s - lse) * log2(e). Either difference can round a
ds (before dS.K and dS^T.Q) or a p (before P^T.dO) to its other bf16
neighbour, which moves a gradient by up to one ulp of that ds or p times
|k|, |q| or |dO| (``chip_smoke.bwd_flip_scale``).

For each comparison it prints a JSON line with three readings per
gradient (``chip_smoke.bwd_reading``):

- ``ulps``: max |got - want| / (BWD_BF16_ATOL x max |want| + 2 ulps(want))
  and the share of elements that differ (the limit without flips);
- ``flip``: the same with BWD_BF16_FLIPS x flip added to the limit;
- ``flips``: the most flips an element's excess over the first limit
  amounts to (the least BWD_BF16_FLIPS that passes).

Cases: ``chip_smoke.py``'s phase 3c bf16 shapes (``BWD_SHAPES``, b 32,
h 12) for N seeds (default 4); the q, k, v, dO, lse and delta that reach
the 12 attention layers of one bf16 BERT-Base fine-tuning step
(chip_smoke.py's classifier, weights and inputs, dropout 0.1); and the
three faulty controls (ds left unrounded before dS.K and dS^T.Q, p before
P^T.dO) at the fine-tuning shape, which must fail. Writes
``chiprun_out/flash_bwd_bf16_limit.json``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from analytics_zoo_tpu_torch.ops import flash_attention as fa  # noqa: E402

import chip_smoke as cs  # noqa: E402

GRADS = ("dq", "dk", "dv")


def readings(got, want, flip):
    """The limit's reading without and with the flip term, the share of
    elements that differ, how many exceed the limit without it, and the
    most flips an element's excess over it amounts to."""
    top = float(want.float().abs().max())
    ulps, share = cs.bf16_reading(got, want, cs.BWD_BF16_ATOL * top)
    with_flip, _ = cs.bwd_reading(got, want, torch.bfloat16, flip)
    w = want.float()
    excess = (got.float() - w).abs() - (cs.BWD_BF16_ATOL * top
                                        + cs.FLASH_BF16_ULPS * cs.bf16_ulp(w))
    flips = torch.where(excess > 0, excess / flip.clamp(min=1e-30), 0.0)
    return dict(ulps=ulps, flip=with_flip, share=share,
                over_ulps=int((excess > 0).sum()), flips=float(flips.max()))


def compare(args):
    """Readings of the kernels against the plain versions on ``args``
    (q, k, v, dO, lse, delta, causal, glse), per gradient."""
    got = (fa._flash_bwd_dq_cuda(*args), *fa._flash_bwd_dkv_cuda(*args))
    want = (fa._flash_bwd_dq_ref(*args), *fa._flash_bwd_dkv_ref(*args))
    flips = cs.bwd_flip_scale(fa, *args)
    return {g: readings(a, w, f)
            for g, a, w, f in zip(GRADS, got, want, flips)}, want, flips


def case_args(gen, dev, b, h, sq, sk, causal, packed, with_glse, d):
    """phase 3c's inputs of one case, in bf16."""
    randn = lambda *shape: torch.randn(*shape, generator=gen).to(
        dev, torch.bfloat16)
    if packed:
        q, k, v = randn(b, sq, 3, h, d).unbind(2)
        do = randn(b, h, sq, d).transpose(1, 2)
    else:
        q, k, v = randn(b, sq, h, d), randn(b, sk, h, d), randn(b, sk, h, d)
        do = randn(b, sq, h, d)
    glse = torch.randn(b * h, sq, generator=gen).to(dev) if with_glse \
        else None
    o, lse = fa.flash_attention_with_lse(q, k, v, causal)
    return (q, k, v, do, lse, fa._row_delta(o, do), causal, glse)


def train_activations(dev):
    """The backward kernels' inputs at each of the 12 layers of one bf16
    BERT-Base fine-tuning step (chip_smoke.py's classifier and inputs,
    dropout 0.1)."""
    seen = []
    launch = fa._flash_bwd_cuda

    def capture(q, k, v, o, lse, do, causal, glse=None):
        do = do.to(q.dtype)
        seen.append(tuple(t.clone() if torch.is_tensor(t) else t
                          for t in (q, k, v, do, lse, fa._row_delta(o, do),
                                    causal, glse)))
        return launch(q, k, v, o, lse, do, causal, glse)

    ids, labels = cs.train_inputs(np.random.RandomState(cs.SEED),
                                  cs.TRAIN_BATCH)
    module = cs.bert_classifier(None, use_flash=True,
                                dtype=torch.bfloat16).to(dev)
    fa._flash_bwd_cuda = capture
    try:
        cs.step_grads(torch, module, ids, labels)
    finally:
        fa._flash_bwd_cuda = launch
    return seen


def card(n_seeds: int):
    dev = torch.device("cuda")
    b, h = cs.TRAIN_BATCH, 12
    recs = []
    for seed in range(n_seeds):
        gen = torch.Generator(device="cpu").manual_seed(cs.SEED + 1 + seed)
        for name, sq, sk, causal, packed, with_glse, d in cs.BWD_SHAPES:
            args = case_args(gen, dev, b, h, sq, sk, causal, packed,
                             with_glse, d)
            rec = dict(pair="kernel vs plain", case=name, seed=seed)
            rec["grads"], want, flips = compare(args)
            if name == "bert_train" and seed == 0:
                rec["controls"] = cs.bwd_bf16_controls(fa, args, want, flips)
            recs.append(rec)
            print(json.dumps(rec), flush=True)
            del args, want, flips
    for layer, args in enumerate(train_activations(dev)):
        rec = dict(pair="kernel vs plain", case="bert_train_activations",
                   layer=layer)
        rec["grads"], _, _ = compare(args)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    return recs


def worst(recs):
    """The largest readings per gradient over the random cases and over
    the fine-tuning step's activations."""
    out = {}
    for rec in recs:
        kind = "activations" if rec["case"] == "bert_train_activations" \
            else "random"
        for g, r in rec["grads"].items():
            acc = out.setdefault(f"{kind}_{g}", dict(
                ulps=0.0, flip=0.0, share=0.0, over_ulps=0, flips=0.0))
            for key in acc:
                acc[key] = max(acc[key], r[key])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_bf16_limit: needs a CUDA device", file=sys.stderr)
        return 2
    n_seeds = int(sys.argv[sys.argv.index("--seeds") + 1]) \
        if "--seeds" in sys.argv else 4
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": cs.card_line(), "flips_allowed": cs.BWD_BF16_FLIPS}
    print(out["card"], flush=True)
    out["card_cases"] = card(n_seeds)
    out["worst"] = worst(out["card_cases"])
    print(json.dumps({"worst": out["worst"]}), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "flash_bwd_bf16_limit.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
