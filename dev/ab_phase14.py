"""Times the host-bound parts of ``chip_smoke.py``'s phase 14 from one
checkout, to compare two checkouts on one card in turns.

The parts are (a) the NCF loop modes, (b) the eight optimizers and (d)
the BERT task fits, each as ``chip_smoke.py`` runs it; the kernels are
built first. The last line of the output is ``AB {json}`` with each
part's seconds and the NCF step ms of each loop mode.

Run it from the repo root on a machine with a card, once a checkout and
in alternating order, e.g. with two checkouts unpacked under build/::

    for t in parent final final parent parent final final parent; do
        python3 dev/ab_phase14.py build/$t $t | grep '^AB '
    done
"""
import json
import os
import shutil
import sys
import time

tree = os.path.abspath(sys.argv[1])
os.chdir(tree)
sys.path.insert(0, tree)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch.learn import estimator  # noqa: E402
from analytics_zoo_tpu_torch.ops import _build  # noqa: E402
from analytics_zoo_tpu_torch.ops import autotune  # noqa: E402

os.makedirs(cs.AUTOTUNE_DIR, exist_ok=True)
os.environ["ZOO_AUTOTUNE_CACHE"] = os.path.join(cs.AUTOTUNE_DIR, "ab.json")
os.environ["ZOO_AUTOTUNE"] = "off"
autotune.reset_tuner()
t = time.perf_counter()
_build.build()
out = {"tree": sys.argv[2], "build_s": time.perf_counter() - t}
torch.backends.cuda.matmul.allow_tf32 = False
x, y, _ = cs.ncf_train_data(np)
shutil.rmtree(cs.PHASE14_DIR, ignore_errors=True)
os.makedirs(cs.PHASE14_DIR)
estimator.DEFAULT_LOG_DIR = os.path.join(cs.PHASE14_DIR, "logs")
card = cs.card_line()
kind = torch.cuda.get_device_name(0)
t = time.perf_counter()
r = cs.phase_ncf_loops(torch, np, x, y, kind)
out["ncf_loops_s"] = time.perf_counter() - t
out["ncf_step_ms"] = {m: r[m]["step_ms"] for m in ("per_step", "staged",
                                                    "cached")}
t = time.perf_counter()
cs.phase_optimizers(torch, np, x, y, card)
out["optimizers_s"] = time.perf_counter() - t
t = time.perf_counter()
cs.phase_bert_tasks(torch, np, card)
out["tasks_s"] = time.perf_counter() - t
shutil.rmtree(cs.PHASE14_DIR, ignore_errors=True)
print("AB " + json.dumps(out), flush=True)
