#!/usr/bin/env python3
"""How far a bf16 flash-attention forward may sit from its plain version.

    python3 dev/flash_bf16_limit.py [--seeds N]   # the card, if there is one
    python3 dev/flash_bf16_limit.py --cpu         # the reference pairs only

The plain version (``ops.flash_attention._flash_fwd_ref``) computes the
scores with an fp32 matmul and p with ``torch.exp``; the bf16 kernel
computes the scores on the tensor cores, whose fp32 sums of the exact bf16
products round in another order, and p with ``ex2.approx`` of
(x - m) * log2(e). Either difference can round a p = exp(s - m) to the
other bf16 neighbour, and that moves each output of the row by up to
2^-8 * p / l * |v| (one bf16 ulp of p, over the row's sum l): for a small
output, produced by cancellation, more than 2 of its own ulps.

Two readings of each comparison (``chip_smoke.bf16_reading``), printed
as JSON lines:

- ``ulps``: max |got - want| / (1e-5 + 2 ulps(want)) and the share of
  elements that differ (the limit without p flips);
- ``flip``: max |got - want| / (1e-5 + 2 ulps(want) + FLASH_BF16_FLIPS x
  flip), with flip = 2^-8 * exp(m - lse) * max_j |v_j| per row and column
  (``chip_smoke.bf16_flip_scale``; m the row's largest score, so
  exp(m - lse) = 1 / l): one p flip;
- ``flips``: the most flips an element's excess over the first limit
  amounts to (the least FLASH_BF16_FLIPS that passes).

On the CPU it measures reference pairs at a few shapes (b 2, h 3): the
plain version against the same function with each score summed exactly
and rounded once to fp32, and against that function with p also taken as
exp2 of (x - m) * log2(e) (the kernel's two differences, short of the
last bit of ``ex2.approx``). On the card it measures the kernel against
the plain version at ``chip_smoke.py``'s bf16 shapes for N seeds
(default 4), on the q, k and v that reach the 12 attention layers of a
bf16 BERT-Base predict (chip_smoke.py's classifier and inputs), and the
two faulty controls (p left unrounded, the output truncated), which must
fail. Writes ``chiprun_out/flash_bf16_limit.json``.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from analytics_zoo_tpu_torch.ops import flash_attention as fa  # noqa: E402

import chip_smoke as cs  # noqa: E402


def readings(got, want, flip):
    """The limit's reading without and with the flip term, the share of
    elements that differ, how many exceed the limit without it, and the
    most flips an element's excess over it amounts to (the least
    FLASH_BF16_FLIPS that passes)."""
    ulps, share = cs.bf16_reading(got, want)
    with_flip, _ = cs.bf16_reading(got, want, flip=flip)
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    ulp = torch.where(w == 0, 0.0, ulp)
    excess = (g - w).abs() - (cs.FLASH_BF16_ATOL + cs.FLASH_BF16_ULPS * ulp)
    flips = torch.where(excess > 0, excess / flip, 0.0)
    return dict(ulps=ulps, flip=with_flip, share=share,
                over_ulps=int((excess > 0).sum()), flips=float(flips.max()))


def exact_scores_ref(q, k, v, causal, exp2: bool = False):
    """``_flash_fwd_ref`` with each score's dot product summed in float64
    and rounded once to fp32 (a second correct fp32 score), and with
    ``exp2`` p taken as exp2((x - m) * log2(e)) in fp32 steps."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sm_scale = float(np.float32(1.0 / math.sqrt(d)))
    log2e = float(np.float32(math.log2(math.e)))

    def exp_diff(x, m):
        return torch.exp2((x - m) * log2e) if exp2 else torch.exp(x - m)

    qf, kf, vf = (t.double().permute(0, 2, 1, 3) for t in (q, k, v))
    q_pos = torch.arange(sq)
    o = torch.zeros((b, h, sq, d))
    m = torch.full((b, h, sq), fa.NEG_INF)
    l = torch.zeros((b, h, sq))
    for k0 in range(0, sk, fa.BLOCK_K):
        kb, vb = kf[:, :, k0:k0 + fa.BLOCK_K], vf[:, :, k0:k0 + fa.BLOCK_K]
        s = torch.matmul(qf, kb.transpose(-1, -2)).float() * sm_scale
        masked = None
        if causal:
            k_pos = k0 + torch.arange(kb.shape[2])
            masked = k_pos[None, :] > q_pos[:, None] + (sk - sq)
            s = torch.where(masked, fa.NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1))
        p = exp_diff(s, m_new[..., None])
        if masked is not None:
            p = torch.where(masked, 0.0, p)
        corr = exp_diff(m, m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.matmul(p.to(v.dtype).float(),
                                               vb.float())
        m = m_new
    return (o / torch.clamp(l, min=1e-37)[..., None]).permute(
        0, 2, 1, 3).to(q.dtype)


def cpu_pair():
    recs = []
    for seed, (sq, sk, causal) in enumerate(
            [(256, 256, False), (256, 256, True), (200, 200, False),
             (64, 256, True), (512, 512, False)]):
        gen = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn(2, s, 3, 64, generator=gen).to(torch.bfloat16)
                   for s in (sq, sk, sk))
        want, lse = fa._flash_fwd_ref(q, k, v, causal, return_lse=True)
        flip = cs.bf16_flip_scale(q, k, v, causal, lse)
        for pair, exp2 in (("exact scores vs plain", False),
                           ("exact scores, exp2 vs plain", True)):
            got = exact_scores_ref(q, k, v, causal, exp2=exp2)
            rec = dict(pair=pair, sq=sq, sk=sk, causal=causal,
                       **readings(got, want, flip))
            recs.append(rec)
            print(json.dumps(rec), flush=True)
    return recs


def bert_activations(dev):
    """(q, k, v) as they reach each flash-attention launch of a bf16
    BERT-Base predict of chip_smoke.py's inputs, weights from its seed."""
    seen = []
    launch = fa._flash_fwd_cuda

    def capture(q, k, v, causal, return_lse):
        seen.append((q.clone(), k.clone(), v.clone(), causal))
        return launch(q, k, v, causal, return_lse)

    ids, seg = cs.bert_inputs(np.random.RandomState(cs.SEED),
                              cs.BERT_BATCH)
    module = cs.bert_classifier(None, use_flash=True,
                                dtype=torch.bfloat16).to(dev).eval()
    fa._flash_fwd_cuda = capture
    try:
        with torch.no_grad():
            module(torch.from_numpy(ids).to(dev),
                   torch.from_numpy(seg).to(dev))
    finally:
        fa._flash_fwd_cuda = launch
    return seen


def card(n_seeds: int):
    dev = torch.device("cuda")
    recs = []
    b, h = cs.BERT_BATCH, 12
    for seed in range(n_seeds):
        gen = torch.Generator(device="cpu").manual_seed(cs.SEED + seed)
        for name, sq, sk, causal, packed, d in [
                ("bert_base", 512, 512, False, True, 64),
                ("causal", 512, 512, True, False, 64),
                ("ragged", 500, 500, False, False, 64),
                ("causal_cross", 128, 512, True, False, 64),
                ("bert_train", 128, 128, False, True, 64),
                ("head_dim_128", 512, 512, False, False, 128)]:
            if packed:
                q, k, v = torch.randn(b, sq, 3, h, d, generator=gen).to(
                    dev, torch.bfloat16).unbind(2)
            else:
                q = torch.randn(b, sq, h, d, generator=gen).to(
                    dev, torch.bfloat16)
                k, v = (torch.randn(b, sk, h, d, generator=gen).to(
                    dev, torch.bfloat16) for _ in range(2))
            got = fa.flash_attention(q, k, v, causal)
            want, lse = fa._flash_fwd_ref(q, k, v, causal, return_lse=True)
            flip = cs.bf16_flip_scale(q, k, v, causal, lse)
            rec = dict(pair="kernel vs plain", case=name, seed=seed,
                       **readings(got, want, flip))
            if name == "bert_base" and seed == 0:
                controls = {
                    "p_unrounded": fa._flash_fwd_ref(
                        q.float(), k.float(), v.float(), causal).to(
                            torch.bfloat16),
                    "output_truncated": cs.truncate_to_bf16(
                        fa._flash_fwd_ref(q.float(), k.float(), v,
                                          causal))}
                rec["controls"] = {c: readings(x, want, flip)
                                   for c, x in controls.items()}
            recs.append(rec)
            print(json.dumps(rec), flush=True)
            del q, k, v, got, want, flip
    for layer, (q, k, v, causal) in enumerate(bert_activations(dev)):
        got = fa.flash_attention(q, k, v, causal)
        want, lse = fa._flash_fwd_ref(q, k, v, causal, return_lse=True)
        rec = dict(pair="kernel vs plain", case="bert_activations",
                   layer=layer, **readings(
                       got, want, cs.bf16_flip_scale(q, k, v, causal, lse)))
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    return recs


def worst(recs):
    """The largest readings over the kernel's (or a pair's) records."""
    out = {}
    for rec in recs:
        acc = out.setdefault(rec["pair"], dict(
            ulps=0.0, flip=0.0, share=0.0, over_ulps=0, flips=0.0))
        for key in acc:
            acc[key] = max(acc[key], rec[key])
    return out


def main() -> int:
    n_seeds = int(sys.argv[sys.argv.index("--seeds") + 1]) \
        if "--seeds" in sys.argv else 4
    on_card = torch.cuda.is_available() and "--cpu" not in sys.argv
    out = {"cpu_pair": None if on_card else cpu_pair()}
    if on_card:
        out["card_name"] = cs.card_line()
        print(out["card_name"], flush=True)
        out["card"] = card(n_seeds)
    out["worst"] = worst(out["card"] if on_card else out["cpu_pair"])
    print(json.dumps({"worst": out["worst"]}), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "flash_bf16_limit.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
