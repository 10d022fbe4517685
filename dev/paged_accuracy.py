#!/usr/bin/env python3
"""How far the paged decode attention kernel sits from the exact answer,
beside JAX's float32 reference, on one GPU.

    python3 dev/paged_accuracy.py [--seeds N] [--variants A,B]

The limit that ``chip_smoke.py`` and the card tests hold the kernel to
(``PAGED_RTOL`` / ``PAGED_ATOL``, JAX's for its Pallas kernel) is taken
against ``paged_attention_ref(..., dtype=torch.float64)``: the same
softmax of the same float32 inputs, computed in float64. This script
sets the basis for that choice and for the kernel's score arithmetic. For
N seeds (default 4) of each shape (the card tests' ``CUDA_SHAPES`` and
chip_smoke.py's phase 3d attention shapes, drawn by chip_smoke.py's
``paged_case``), fp32 and int8, a pool aligned and one element into its
storage (one-element loads), and one split, the plan's and one split a
page slot (at most ``MAX_SPLITS``), it records the largest error and the
largest share of the limit (chip_smoke.py's ``paged_share``: ``|got -
exact| / (atol + rtol |exact|)``, over 1 fails), over every split count
and at the plan's, of:

- the float32 reference (JAX's ``paged_attention_ref``, the CPU route);
- the kernel as built (the score's dot product summed in float64 and
  rounded once);
- variants of ``dev/paged_variants.py`` (default ``f32_dot``: the dot
  product summed in float32), built by nvcc into ``build/variants/``.

Writes ``chiprun_out/paged_accuracy.json``; prints one line a case.
"""

from __future__ import annotations

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, n_pages, page_size, dim, batch, width)
SHAPES = [("tests_slice", 136, 8, 8, 8, 5), ("tests_d6", 9, 4, 6, 3, 3),
          ("tests_wide", 600, 16, 128, 32, 16),
          ("tests_b1_2048", 160, 16, 128, 1, 128),
          ("tests_d64", 48, 8, 64, 4, 12), ("tests_d1024", 40, 4, 1024, 3, 8),
          ("jax_tests", 7, 4, 8, 4, 2), ("wide", 32 * 256, 16, 128, 32, 256),
          ("long", 8 * 2048, 16, 128, 8, 2048)]


def shifted(torch, pool):
    out = torch.empty(pool.numel() + 1, dtype=pool.dtype,
                      device=pool.device)[1:].view(pool.shape)
    out.copy_(pool)
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "dev"))
    import torch
    if not torch.cuda.is_available():
        print("paged_accuracy: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paged_variants
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import paged_attention as pa

    seeds = int(sys.argv[sys.argv.index("--seeds") + 1]) \
        if "--seeds" in sys.argv else 4
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["paged_attention"])
    names = sys.argv[sys.argv.index("--variants") + 1].split(",") \
        if "--variants" in sys.argv else ["f32_dot"]
    libs, _ = paged_variants.build_variants(names)
    libs = {"as_built": pa._lib(), **libs}
    own = pa._lib()
    n_sm = pa._sm_count(torch.cuda.current_device())
    dev = torch.device("cuda")
    out = {"card": cs.card_line(), "torch": torch.__version__,
           "limit": [cs.PAGED_RTOL, cs.PAGED_ATOL], "cases": []}
    print(out["card"], flush=True)
    worst = {}
    for seed in range(seeds):
        gen = torch.Generator(device="cpu").manual_seed(1000 + seed)
        for name, n_pages, ps, d, batch, width in SHAPES:
            for dtype in (torch.float32, torch.int8):
                kp, ks, table, lengths = cs.paged_case(
                    torch, gen, dev, dtype, n_pages, ps, d, batch, width)
                vp, vs, _, _ = cs.paged_case(torch, gen, dev, dtype, n_pages,
                                             ps, d, batch, width)
                q = torch.randn(batch, d, generator=gen).to(dev)
                quant = dtype == torch.int8
                if not quant:
                    ks = vs = None
                kw = dict(k_scales=ks, v_scales=vs)
                exact = pa.paged_attention_ref(q, kp, vp, table, lengths,
                                               dtype=torch.float64, **kw)
                ref32 = pa.paged_attention_ref(q, kp, vp, table, lengths,
                                               **kw)
                rec = dict(case=name, dtype=str(dtype), seed=seed,
                           ref32=dict(err=cs.max_abs_err(ref32, exact),
                                      share=cs.paged_share(ref32, exact)))
                plan = pa._attention_plan(batch, width, ps, d, quant, n_sm)[0]
                splits = sorted({1, plan, min(width, pa.MAX_SPLITS)})
                pools = {"aligned": (kp, vp),
                         "shifted": (shifted(torch, kp), shifted(torch, vp))}
                for label, lib in libs.items():
                    pa._lib_handle = lib
                    try:
                        errs, by_splits = [], {}
                        for k_t, v_t in pools.values():
                            for n in splits:
                                got = pa._attention_cuda(
                                    q, k_t, v_t, table, lengths, ks, vs,
                                    1.0 / math.sqrt(d), splits=n)
                                errs.append(cs.max_abs_err(got, exact))
                                by_splits[n] = max(by_splits.get(n, 0.0),
                                                   cs.paged_share(got, exact))
                    finally:
                        pa._lib_handle = own
                    rec[label] = dict(err=max(errs),
                                      share=max(by_splits.values()),
                                      share_by_splits=by_splits,
                                      planned_share=by_splits[plan])
                rec["planned_splits"] = plan
                for label in ("ref32", *libs):
                    for key in ("share", "planned_share"):
                        if key not in rec[label]:
                            continue
                        w = worst.setdefault(f"{label}_{key}", dict(share=0.0))
                        if rec[label][key] > w["share"]:
                            worst[f"{label}_{key}"] = dict(
                                err=rec[label]["err"], share=rec[label][key],
                                case=name, dtype=str(dtype), seed=seed)
                out["cases"].append(rec)
                print(json.dumps(rec), flush=True)
                del kp, vp, pools, exact, ref32
    out["worst"] = worst
    print(json.dumps({"worst": worst}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "paged_accuracy.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
