#!/usr/bin/env python3
"""chip_smoke.py's phase 22 alone, on one GPU: the autotuner's verdicts
and the routes that read them (BERT-Base at use_flash=None,
measure_flash_attention, the lookup's, bag's and paged kernels' verdicts,
the warm-up queue, decode's paged="auto"), Friesian into the NCF fit at
bench.py's size and at MovieLens-1M's shape under NATIVE_4, and
TorchEstimator.predict's pipeline window.

    python3 dev/autotune_friesian_torch.py [parts]

``parts`` is a subset of ``abcdefgh`` (all by default; ``h`` needs
``g``). Builds the kernels first, keeps its verdicts in a file of its own
(removed after), runs with TF32 off, prints its lines and the card's name
and power limit, and writes chiprun_out/autotune_friesian_torch.json.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import _build, autotune

    if not torch.cuda.is_available():
        print("autotune_friesian_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    os.chdir(ROOT)
    parts = sys.argv[1] if len(sys.argv) > 1 else "abcdefgh"
    card = cs.card_line()
    cs.log(card)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cs.log(f"build: {_build.build():.1f} s")
    shutil.rmtree(cs.AUTOTUNE_DIR, ignore_errors=True)
    os.makedirs(cs.AUTOTUNE_DIR)
    os.environ["ZOO_AUTOTUNE_CACHE"] = os.path.join(cs.AUTOTUNE_DIR,
                                                    "autotune.json")
    os.environ["ZOO_AUTOTUNE"] = "off"
    autotune.reset_tuner()
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    if parts == "abcdefgh":
        rep = cs.phase_autotune_friesian(torch, np, kind)
    else:
        rep, est = {}, None
        steps = {
            "a": lambda: cs.p22_attention_verdicts(torch, np, kind),
            "b": lambda: cs.p22_flash_bench(torch, kind),
            "c": lambda: cs.p22_kernel_verdicts(torch, np, kind),
            "d": lambda: cs.p22_queue(torch, np, kind),
            "e": lambda: cs.p22_decode(torch, np, kind),
            "f": lambda: cs.p22_recsys(torch, np, kind),
            "g": lambda: cs.p22_ml1m(torch, np, kind),
            "h": lambda: cs.p22_predict_windows(torch, np, est, kind)}
        with cs.p17_tf32(torch, False):
            for p in parts:
                mode = "sync" if p == "b" else os.environ["ZOO_AUTOTUNE"]
                with cs.autotune_mode(mode):
                    out = cs.p19_part(rep, p, steps[p], phase=22)
                if p == "g":
                    out, est = out
                rep[p] = out
    shutil.rmtree(cs.AUTOTUNE_DIR, ignore_errors=True)
    cs.log(f"phase 22 parts {parts}: seconds "
           f"{ {k: round(v, 1) for k, v in rep['part_seconds'].items()} }; "
           f"launches {rep['launches']}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "autotune_friesian_torch.json"),
              "w") as fh:
        json.dump(dict(card=card, **rep), fh, indent=1, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
