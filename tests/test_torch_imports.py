"""The port stands alone: importing analytics_zoo_tpu_torch (every
module) loads no jax, flax or optax and nothing of analytics_zoo_tpu, and
no source of the port or of chip_smoke.py imports them. Nor msgpack or
ml_dtypes, which the card's machine lacks: the port writes and reads
flax's checkpoint encoding itself (learn/checkpoint.py)."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "analytics_zoo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "analytics_zoo_tpu",
             "msgpack", "ml_dtypes")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _modules():
    import analytics_zoo_tpu_torch
    return ["analytics_zoo_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            analytics_zoo_tpu_torch.__path__, "analytics_zoo_tpu_torch.")]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         check=True, capture_output=True, text=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("serving.engine", "ops.flash_attention", "ops.attention",
                "text.bert", "text.estimators", "text.hf_import",
                "common.flax_compat", "ops.paged_attention",
                "inference.generation", "inference.decode_scheduler",
                "inference.quantize", "models.seq2seq.seq2seq",
                "learn.checkpoint", "learn.trigger", "common.resilience",
                "common.context", "common.summary", "keras.regularizers",
                "models.recommendation.wide_and_deep",
                "models.recommendation.session_recommender",
                "models.anomalydetection.anomaly_detector",
                "parallel.mesh", "data.shard", "data.dataset",
                "data.pandas.preprocessing", "automl.metrics",
                "zouwu.model.nets", "zouwu.model.forecast"):
        assert f"analytics_zoo_tpu_torch.{mod}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    # pandas is imported inside the functions that handle a DataFrame
    assert "pandas" not in loaded


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert bad == [], f"{path} imports {bad}"
