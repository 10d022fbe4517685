#!/usr/bin/env python3
"""Where a ResNet-50 training step's rounding goes: each route's loss,
logits, layer outputs and gradients against the same step in float64 on
the CPU, and the step's own conditioning in float64. The basis of
chip_smoke.py's phase 17(b) limits.

    python3 dev/diagnose_resnet50_step.py [--size 224] [--rows 4]
        [--out chiprun_out/diagnose_resnet50.json]

Builds chip_smoke.py's phase 17 model (``ImageClassifier(resnet-50)``,
2 classes, weights from its numpy seed) and takes phase 17(b)'s batch
through the estimator's ``_loss_and_grads`` (train mode) on each route:

- ``f64``: the module in float64 on the CPU, the reference;
- ``f64_eps<e>``: the same with the input scaled by ``1 + e * noise``, so
  the step's own amplification of a relative perturbation shows without
  any rounding of fp32;
- ``cpu``, ``cpu_rev`` (rows reversed), ``cpu_nomkldnn``: fp32 on the CPU;
- on a card (TF32 off): ``cuda``, ``cuda_rev``, ``cuda_det``
  (``cudnn.deterministic``), ``cuda_det_rev``, ``cuda_bench``
  (``cudnn.benchmark``), and ``cuda_bf16`` (``mixed_bfloat16``).

For each route against ``f64``: the loss's distance, the logits' (the
Dense's output before the softmax) and each convolution's and norm's
output as a norm of the difference over the reference's norm (the worst
layer and the first layer past 1e-4), the whole gradient's distance over
its norm, the worst leaf's largest difference over its largest element,
and the gradient distance of the head (the Dense and the last norm). On
a card, the convolution kernels each fp32 route ran, from the profiler.
Then the eval-mode logits of the fp32 model on the card and on the CPU
against float64, with the softmax's mean top probability. Prints one
JSON object and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    ref = float(b.norm())
    return float((a - b).norm()) / ref if ref else float((a - b).norm())


def main() -> int:
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.flax_compat import (
        BatchNorm, Conv, Dense,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=chip_smoke.P17_IMAGE)
    ap.add_argument("--rows", type=int, default=chip_smoke.P17_CHECK_ROWS)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    chip_smoke.P17_IMAGE = args.size
    x, y = chip_smoke.p17_data(np, args.rows, seed=5)
    base = chip_smoke.p17_classifier(np, "float32")
    state = {k: v.clone() for k, v in base.model.module.state_dict().items()}
    cuda = torch.cuda.is_available()
    bk = torch.backends

    def run(dtype="float32", device="cpu", rows=slice(None), f64=False,
            eps=0.0, profile=False, flags=()):
        clf = chip_smoke.p17_classifier(np, dtype, state=state)
        mod = clf.model.module
        if f64:
            mod.double()
        clf.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                    device=device)
        outs, hooks = {}, []

        def keep(name):
            def hook(m, a, out):
                outs[name] = out.detach().double().cpu()
            return hook

        for name, m in mod.named_modules():
            if isinstance(m, (Conv, BatchNorm, Dense)):
                hooks.append(m.register_forward_hook(keep(name)))
        xi = x[rows]
        if eps:
            noise = np.random.default_rng(11).standard_normal(xi.shape)
            xi = (xi.astype(np.float64) * (1 + eps * noise))
        saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in flags]
        for obj, attr, val in flags:
            setattr(obj, attr, val)
        kernels = None
        try:
            if profile:
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    loss, grads = chip_smoke.p17_grads(
                        clf.model.estimator, np.ascontiguousarray(xi),
                        np.ascontiguousarray(y[rows]))
                    torch.cuda.synchronize()
                kernels = sorted({e.name for e in prof.events()
                                  if e.device_type.name == "CUDA"
                                  and any(s in e.name.lower() for s in (
                                      "conv", "fprop", "dgrad", "wgrad",
                                      "winograd", "fft", "implicit",
                                      "gemm", "nvjet"))})
            else:
                loss, grads = chip_smoke.p17_grads(
                    clf.model.estimator, np.ascontiguousarray(xi),
                    np.ascontiguousarray(y[rows]))
        finally:
            for obj, attr, val in saved:
                setattr(obj, attr, val)
            for h in hooks:
                h.remove()
        if rows != slice(None):
            # layer outputs back in the reference's row order
            outs = {k: v.flip(0) for k, v in outs.items()}
        return dict(loss=loss, grads=grads, outs=outs, kernels=kernels,
                    names=list(clf.model.estimator._names))

    ref = run(f64=True)
    names = ref["names"]
    dense = [n for n in names if ".weight" in n or ".bias" in n]
    logits_key = [k for k in ref["outs"]
                  if isinstance(dict(base.model.module.named_modules())[k],
                                Dense)][-1]
    head = [n for n in names if n.startswith(logits_key)] + [
        n for n in names if n.startswith(
            [k for k in ref["outs"] if isinstance(
                dict(base.model.module.named_modules())[k],
                BatchNorm)][-1])]
    g64 = ref["grads"]
    norm64 = math.sqrt(sum(float((g.double() ** 2).sum())
                           for g in g64.values()))

    def reading(r):
        out = {"loss": r["loss"], "loss_diff": abs(r["loss"] - ref["loss"])}
        layer = {k: _rel(v, ref["outs"][k]) for k, v in r["outs"].items()}
        order = list(ref["outs"])
        out["logits_rel"] = layer[logits_key]
        worst = max(layer, key=layer.get)
        out["layer_worst"] = [worst, layer[worst]]
        first = next((k for k in order if layer[k] > 1e-4), None)
        out["layer_first_past_1e-4"] = [first, layer.get(first)]
        out["layer_rel_by_depth"] = [round(layer[k], 9) for k in order]
        diff = math.sqrt(sum(float(((r["grads"][n].double()
                                     - g.double()) ** 2).sum())
                             for n, g in g64.items()))
        out["grad_norm_rel"] = diff / norm64
        rel, worst = chip_smoke.grad_reading(r["grads"], g64)
        out["grad_leaf_worst"] = [worst, rel]
        hd = math.sqrt(sum(float(((r["grads"][n].double()
                                   - g64[n].double()) ** 2).sum())
                           for n in head))
        hn = math.sqrt(sum(float((g64[n].double() ** 2).sum())
                           for n in head))
        out["head_grad_rel"] = hd / hn
        out["leaf_norm_rel_by_depth"] = [
            round(_rel(r["grads"][n], g64[n]), 7) for n in dense]
        if r["kernels"] is not None:
            out["kernels"] = r["kernels"]
        return out

    res = {"size": args.size, "rows": args.rows, "f64_loss": ref["loss"],
           "head": head, "logits": logits_key,
           "layers": list(ref["outs"]), "leaves": dense,
           "device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "routes": {}}
    routes = [("f64_eps1e-7", dict(f64=True, eps=1e-7)),
              ("f64_eps1e-5", dict(f64=True, eps=1e-5)),
              ("f64_eps1e-3", dict(f64=True, eps=1e-3)),
              ("cpu", {}), ("cpu_rev", dict(rows=slice(None, None, -1))),
              ("cpu_nomkldnn", dict(flags=((bk.mkldnn, "enabled", False),)))]
    if cuda:
        off = ((bk.cuda.matmul, "allow_tf32", False),
               (bk.cudnn, "allow_tf32", False))
        det = off + ((bk.cudnn, "deterministic", True),
                     (bk.cudnn, "benchmark", False))
        routes += [
            ("cuda", dict(device="cuda", flags=off, profile=True)),
            ("cuda_rev", dict(device="cuda", flags=off,
                              rows=slice(None, None, -1))),
            ("cuda_det", dict(device="cuda", flags=det, profile=True)),
            ("cuda_det_rev", dict(device="cuda", flags=det,
                                  rows=slice(None, None, -1))),
            ("cuda_bench", dict(device="cuda", profile=True, flags=off + (
                (bk.cudnn, "benchmark", True),))),
            ("cuda_bf16", dict(device="cuda", dtype="mixed_bfloat16")),
        ]
    for label, kw in routes:
        res["routes"][label] = reading(run(**kw))
        r = res["routes"][label]
        print(f"{label}: loss {r['loss_diff']:.3g}, logits "
              f"{r['logits_rel']:.3g}, worst layer {r['layer_worst']}, "
              f"gradient {r['grad_norm_rel']:.3g} of its norm, worst leaf "
              f"{r['grad_leaf_worst']}, head {r['head_grad_rel']:.3g}",
              flush=True)
    # eval-mode logits: the fp32 model on each device against float64
    ev = {}
    for label, device, f64 in (("f64", "cpu", True), ("cpu", "cpu", False)) \
            + ((("cuda", "cuda", False),) if cuda else ()):
        clf = chip_smoke.p17_classifier(np, "float32", state=state)
        if f64:
            clf.model.module.double()
        clf.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                    device=device)
        got = {}
        dense_mod = dict(clf.model.module.named_modules())[logits_key]
        h = dense_mod.register_forward_hook(
            lambda m, a, o: got.setdefault("z", o.detach().double().cpu()))
        flags = ((bk.cuda.matmul, "allow_tf32", False),
                 (bk.cudnn, "allow_tf32", False)) if device == "cuda" else ()
        saved = [(o, a, getattr(o, a)) for o, a, _ in flags]
        for o, a, v in flags:
            setattr(o, a, v)
        try:
            p = clf.predict(x, batch_size=len(x))
        finally:
            for o, a, v in saved:
                setattr(o, a, v)
            h.remove()
        ev[label] = dict(z=got["z"], top=float(np.max(p, -1).mean()))
    res["eval"] = {k: dict(logits_rel=_rel(v["z"], ev["f64"]["z"]),
                           logits_absmax=float(ev["f64"]["z"].abs().max()),
                           mean_top_prob=v["top"])
                   for k, v in ev.items()}
    brief = {k: v for k, v in res.items() if k not in ("layers", "leaves")}
    brief["routes"] = {k: {a: b for a, b in v.items()
                           if not a.endswith("_by_depth")}
                       for k, v in res["routes"].items()}
    print(json.dumps(brief, default=str))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
