#!/usr/bin/env python3
"""chip_smoke.py's phase 20 alone, on one GPU: Zouwu's AutoTS (the grid
and bayes searches over a series of nyc_taxi's shape, the saved pipeline
on the card and the CPU, the population of 16 TCNs beside the serial
search, trials from a thread pool, MTNet, TCMF at the electricity panel's
width and the anomaly detectors).

    python3 dev/zouwu_path_torch.py [--determinism] [--population]
                                    [--no-phase]

No CUDA kernel of the port is on this path, so nothing is built. TF32 is
off inside the phase. Prints its lines and the card's name and power
limit, and writes chiprun_out/zouwu_path_torch.json. ``--determinism``
then reads phase 20(e)'s basis in the same process: one search
(TCNGridRandomRecipe, 2 draws, 1 epoch) run serially five times with
cuDNN's default algorithms, on four threads, twice with cuDNN off and
twice under cudnn.deterministic, each serial run held against the first
of its kind trial by trial and step by step (the training losses), and
the convolution kernels of each default run by name. ``--population``
reads phase 20(d)'s basis: the population and its member 0 trained
alone, five times with cuDNN's defaults and twice deterministic, the
member's distance from itself alone after each step and the convolution
kernels of each side. ``--no-phase`` leaves the phase out (the studies
then run in a fresh process).
"""

from __future__ import annotations

import json
import os
import shutil
import sys

#: serial searches under cuDNN's default algorithms, each under the profiler
P20_DEFAULT_RUNS = 5
#: populations beside their member trained alone, with cuDNN's defaults
P20_POP_RUNS = 5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _search_runner(torch, np, cs, train, val):
    """``search(name, n_par, profiled)``: one TCNGridRandomRecipe search
    (P20_PAR_SAMPLES draws, 1 epoch) on the card; returns its metric
    histories, each trial's training losses a step (serial searches only:
    the losses are keyed by the order in which trials build their
    estimators) and, when ``profiled``, the convolution kernels it launched
    by name and count."""
    import re
    from collections import Counter

    from analytics_zoo_tpu_torch.learn import estimator
    from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer
    from analytics_zoo_tpu_torch.zouwu.config import TCNGridRandomRecipe
    losses = []
    inner = estimator.TorchEstimator._loss_and_grads

    def recording(self, x, y):
        loss, grads = inner(self, x, y)
        if not hasattr(self, "_study_losses"):
            self._study_losses = []
            losses.append(self._study_losses)
        self._study_losses.append(loss)
        return loss, grads

    def search(name, n_par, profiled=False):
        del losses[:]
        trainer = AutoTSTrainer(dt_col="timestamp", target_col="value",
                                horizon=1, logs_dir=cs.P20_DIR, name=name,
                                device="cuda", n_parallel=n_par)
        recipe = TCNGridRandomRecipe(num_rand_samples=cs.P20_PAR_SAMPLES,
                                     epochs=1)
        estimator.TorchEstimator._loss_and_grads = recording
        try:
            if profiled:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    trainer.fit(train, val, recipe=recipe)
            else:
                trainer.fit(train, val, recipe=recipe)
        finally:
            estimator.TorchEstimator._loss_and_grads = inner
        out = dict(histories=np.asarray([t.metric_history for t in
                                         trainer.engine.trials]),
                   configs=[{k: str(v) for k, v in t.config.items()}
                            for t in trainer.engine.trials])
        if n_par == 1:
            out["losses"] = [torch.stack(ls).double().cpu().numpy()
                             for ls in losses]
        if profiled:
            conv = re.compile(cs.P17_CONV_KERNEL)
            out["conv_kernels"] = dict(Counter(
                e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and conv.search(e.name)))
        del losses[:]
        return out

    return search


def _divergence(a, b) -> list:
    """Per trial of two serial searches: the first step whose training
    loss differs, the relative difference there and at the last step, and
    the relative difference of the trial's metric."""
    import numpy as np
    rows = []
    for i, (la, lb) in enumerate(zip(a["losses"], b["losses"])):
        diff = np.abs(la - lb) / np.abs(la)
        first = int(np.argmax(diff > 0)) if (diff > 0).any() else None
        ha, hb = a["histories"][i], b["histories"][i]
        rows.append(dict(trial=i, steps=len(la), first_step=first,
                         rel_first=None if first is None
                         else float(diff[first]),
                         rel_steps=[float(diff[s]) for s in
                                    range(0, len(la), max(1, len(la) // 8))],
                         rel_last=float(diff[-1]),
                         rel_metric=float((np.abs(ha - hb) / np.abs(ha))
                                          .max())))
    return rows


def determinism(torch, np, cs, kind) -> dict:
    """Phase 20(e)'s basis: the same search, serially, with cuDNN's default
    algorithms (P20_DEFAULT_RUNS times, each profiled for its convolution
    kernels), with cuDNN off (PyTorch's own convolutions),
    under cudnn.deterministic, and on four threads; each serial run held
    against the first of its kind trial by trial and step by step."""
    from analytics_zoo_tpu_torch.learn import estimator
    frames = cs.p20_frames(np)
    _, train, val, _ = frames
    shutil.rmtree(cs.P20_DIR, ignore_errors=True)
    os.makedirs(cs.P20_DIR)
    log_dir = estimator.DEFAULT_LOG_DIR
    estimator.DEFAULT_LOG_DIR = os.path.join(cs.P20_DIR, "tb")
    search = _search_runner(torch, np, cs, train, val)
    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.deterministic, cudnn.benchmark)
    runs = {}
    try:
        with cs.p17_tf32(torch, False):
            runs["default"] = [search(f"d{i}", 1, profiled=True)
                               for i in range(P20_DEFAULT_RUNS)]
            runs["four_threads"] = [search("t4", 4)]
            cudnn.enabled = False
            runs["cudnn_off"] = [search(f"o{i}", 1) for i in range(2)]
            cudnn.enabled, cudnn.deterministic = True, True
            runs["deterministic"] = [search(f"x{i}", 1) for i in range(2)]
    finally:
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = saved
        estimator.DEFAULT_LOG_DIR = log_dir
        shutil.rmtree(cs.P20_DIR, ignore_errors=True)

    def rel(a, b):
        return float((np.abs(a["histories"] - b["histories"])
                      / np.abs(a["histories"])).max())

    d0 = runs["default"][0]
    out = dict(
        configs=d0["configs"], benchmark=saved[2],
        histories={k: [r["histories"].ravel().tolist() for r in v]
                   for k, v in runs.items()},
        default_rel=[rel(d0, r) for r in runs["default"][1:]],
        default_bitwise=[bool(np.array_equal(d0["histories"],
                                             r["histories"]))
                         for r in runs["default"][1:]],
        four_threads_rel=rel(d0, runs["four_threads"][0]),
        cudnn_off_rel=rel(*runs["cudnn_off"]),
        cudnn_off_bitwise=bool(np.array_equal(
            runs["cudnn_off"][0]["histories"],
            runs["cudnn_off"][1]["histories"])),
        deterministic_rel=rel(*runs["deterministic"]),
        default_steps=[_divergence(d0, r) for r in runs["default"][1:]],
        cudnn_off_steps=_divergence(*runs["cudnn_off"]),
        conv_kernels=[r["conv_kernels"] for r in runs["default"]],
        same_conv_kernels=[r["conv_kernels"] == d0["conv_kernels"]
                           for r in runs["default"][1:]])
    cs.log(f"phase 20(e)'s basis on {kind}: configs {out['configs']}")
    for k, v in out["histories"].items():
        cs.log(f"  histories {k}: {v}")
    for i, rows in enumerate(out["default_steps"]):
        cs.log(f"  default run {i + 1} against run 0 "
               f"(metric {out['default_rel'][i]:.3g}, bitwise "
               f"{out['default_bitwise'][i]}): {rows}")
    cs.log(f"  cuDNN off, twice: metric {out['cudnn_off_rel']:.3g}, "
           f"bitwise {out['cudnn_off_bitwise']}: {out['cudnn_off_steps']}")
    cs.log(f"  four threads against default run 0 "
           f"{out['four_threads_rel']:.3g}; deterministic twice "
           f"{out['deterministic_rel']:.3g}; cudnn.benchmark {saved[2]}")
    cs.log(f"  convolution kernels of runs 1-{P20_DEFAULT_RUNS - 1} the "
           f"same as run 0's {out['same_conv_kernels']}: run 0's "
           f"{out['conv_kernels'][0]}")
    for i, k in enumerate(out["conv_kernels"][1:]):
        if k != d0["conv_kernels"]:
            cs.log(f"  run {i + 1}'s convolution kernels: {k}")
    return out


def population(torch, np, cs, kind) -> dict:
    """Phase 20(d)'s basis: the population of P20_POP_K TCNs and its
    member 0 trained alone, P20_POP_RUNS times in one process (the first
    time alone before the population, then after it) with cuDNN's default
    algorithms and twice under cudnn.deterministic. Each run gives the
    member's largest difference from itself alone after every step, the
    first step where it passes 1e-4, and the convolution kernels of each
    side by name and count (two steps of each, profiled)."""
    import re
    from collections import Counter

    from analytics_zoo_tpu_torch.automl import PopulationSearchEngine, hp
    from analytics_zoo_tpu_torch.automl import population as pop_mod
    from analytics_zoo_tpu_torch.zouwu.feature import (
        TimeSequenceFeatureTransformer)
    from analytics_zoo_tpu_torch.zouwu.model.nets import TemporalConvNet
    _, train, val, _ = cs.p20_frames(np)
    x, y = TimeSequenceFeatureTransformer(
        past_seq_len=24, dt_col="timestamp",
        target_col="value").fit_transform(train)
    feats = x.shape[-1]

    def creator(config):
        return TemporalConvNet(feats, future_seq_len=1, dropout=0.2,
                               **cs.P20_POP_TCN)

    conv = re.compile(cs.P17_CONV_KERNEL)
    inner = pop_mod.BatchedAdamW.step
    trace = []

    profs = []

    def recording(self, params, grads):
        inner(self, params, grads)
        trace.append(torch.cat([p[0].reshape(-1) for p in params.values()]))
        profs[-1].step()

    def train(space, k):
        del trace[:]
        eng = PopulationSearchEngine(creator, logs_dir=cs.P20_DIR,
                                     name=f"k{k}", seed=cs.SEED,
                                     device="cuda")
        eng.compile((x, y), space, n_sampling=k, epochs=cs.P20_POP_EPOCHS,
                    metric="mse", batch_size=cs.P20_POP_BATCH)
        # the kernels of two steps (the plans are cached by shape)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=3, warmup=1,
                                                 active=2, repeat=1)) as prof:
            profs.append(prof)
            eng.run()
            torch.cuda.synchronize()
        kernels = dict(Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and conv.search(e.name)))
        return eng, torch.stack(trace).cpu(), kernels

    shutil.rmtree(cs.P20_DIR, ignore_errors=True)
    os.makedirs(cs.P20_DIR)
    space = {"lr": hp.loguniform(*cs.P20_POP_LR)}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    pop_mod.BatchedAdamW.step = recording
    lr0 = PopulationSearchEngine(creator, logs_dir=cs.P20_DIR,
                                 seed=cs.SEED, device="cuda").compile(
        (x, y), space, n_sampling=cs.P20_POP_K).trials[0].config["lr"]
    runs = []
    try:
        with cs.p17_tf32(torch, False):
            for r in range(P20_POP_RUNS + 2):
                cudnn.deterministic = r >= P20_POP_RUNS
                first = r == 0
                if first:
                    alone = train({"lr": lr0, "seed": 0}, 1)
                pop = train(space, cs.P20_POP_K)
                if not first:
                    alone = train({"lr": lr0, "seed": 0}, 1)
                steps = (pop[1] - alone[1]).abs().amax(dim=1).numpy()
                big = np.flatnonzero(steps > 1e-4)
                runs.append(dict(
                    deterministic=bool(cudnn.deterministic),
                    alone_first=first,
                    lr=float(lr0),
                    member_err=float(steps[-1]),
                    first_step_over_1e_4=int(big[0]) if len(big) else None,
                    steps=[float(steps[i]) for i in
                           range(0, len(steps), max(1, len(steps) // 16))],
                    pop_kernels=pop[2], alone_kernels=alone[2]))
                cs.log(f"  run {r}: member_err {runs[-1]['member_err']:.3g}, "
                       f"first step over 1e-4 "
                       f"{runs[-1]['first_step_over_1e_4']}")
    finally:
        pop_mod.BatchedAdamW.step = inner
        cudnn.deterministic = saved
        shutil.rmtree(cs.P20_DIR, ignore_errors=True)
    for r, run in enumerate(runs):
        cs.log(f"phase 20(d)'s basis on {kind}, run {r}: "
               + ", ".join(f"{k} {v}" for k, v in run.items()
                           if "kernels" not in k))
        for side in ("pop", "alone"):
            ref = runs[0][f"{side}_kernels"]
            if r == 0 or run[f"{side}_kernels"] != ref:
                cs.log(f"  run {r} {side} kernels: "
                       f"{run[side + '_kernels']}")
    return dict(runs=runs)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("zouwu_path_torch: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    cs.log(card)
    kind = torch.cuda.get_device_name(0)
    rep = {}
    if "--no-phase" not in sys.argv[1:]:
        rep = cs.phase_zouwu(torch, np, kind)
        cs.log(f"phase 20: {rep['seconds']:.1f} s; launches "
               f"{rep['launches']}")
    if "--determinism" in sys.argv[1:]:
        rep["determinism"] = determinism(torch, np, cs, kind)
    if "--population" in sys.argv[1:]:
        rep["population"] = population(torch, np, cs, kind)
    cs.log(card)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "zouwu_path_torch.json"),
              "w") as fh:
        json.dump(dict(card=card, **rep), fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
