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
                "zouwu.model.nets", "zouwu.model.forecast",
                "learn.optimizers", "learn.estimator", "convert",
                "common.telemetry", "common.timeseries", "common.slo",
                "common.pipeline_io", "common.compile_ahead",
                "serving.broker", "serving.frontend", "serving.client",
                "serving.schema", "serving.config", "serving.start",
                "common.profiling", "common.fleet", "observability",
                "models.image", "keras.layers",
                "models.image.imageclassification.image_classifier",
                "models.migration", "models.migration_image", "feature",
                "feature.image", "feature.image.imageset",
                "feature.image.transforms", "feature.text",
                "feature.text.textset",
                "models.textclassification.text_classifier",
                "models.textmatching.knrm", "automl.hp", "automl.search",
                "automl.population", "automl.model_builder",
                "automl.auto_estimator", "automl.xgboost",
                "zouwu.feature.time_sequence", "zouwu.config.recipe",
                "zouwu.autots.forecast", "zouwu.pipeline",
                "zouwu.regression", "zouwu.model.tcmf",
                "zouwu.model.anomaly", "zouwu.model.stats_forecast",
                "models.image.objectdetection",
                "models.image.objectdetection.bbox_util",
                "models.image.objectdetection.evaluation",
                "models.image.objectdetection.multibox_loss",
                "models.image.objectdetection.object_detector",
                "feature.image3d", "feature.image3d.transforms",
                "common.encryption", "ops.autotune", "data.native_store",
                "friesian", "friesian.feature", "friesian.feature.table",
                "parallel.strategy", "parallel.collectives",
                "parallel.launch", "parallel.tensor_parallel",
                "ops.ring_attention", "ops.ulysses", "ops.moe",
                "parallel.pipeline", "parallel.sharded_executable",
                "common.protowire", "data.tfrecord", "data.elastic_search",
                "data.image", "data.image.parquet_dataset",
                "keras.autograd", "keras2", "keras2.layers", "nnframes",
                "nnframes.nn_classifier", "learn.gan", "net", "net.net",
                "net.torch_net", "net.onnx_net", "net.openvino_net"):
        assert f"analytics_zoo_tpu_torch.{mod}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    # pandas is imported inside the functions that handle a DataFrame,
    # PIL where an image is decoded, pyarrow where an Arrow record is read
    # or written and cryptography where a record is encrypted (a host may
    # lack each)
    for lazy in ("pandas", "PIL", "pyarrow", "cryptography"):
        assert lazy not in loaded


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


def test_a3_surface_imports_without_jax():
    """The estimator's loop options, the eight optimizers, the BERT task
    estimators and remat load in a process that never saw JAX."""
    code = (
        "import sys, inspect\n"
        "from analytics_zoo_tpu_torch.learn import optimizers as o\n"
        "from analytics_zoo_tpu_torch.learn.estimator import "
        "TorchEstimator\n"
        "from analytics_zoo_tpu_torch.text import BERTNER, BERTSQuAD, "
        "BertConfig\n"
        "names = ['rmsprop', 'adagrad', 'adadelta', 'adamax', 'nadam', "
        "'lars', 'lamb', 'lbfgs']\n"
        "print([type(o.Optimizer.get(n)).__name__ for n in names])\n"
        "p = inspect.signature(TorchEstimator.fit).parameters\n"
        "assert {'steps_per_loop', 'cache', 'profile', 'profile_steps'} "
        "<= set(p)\n"
        "assert BertConfig(remat=True).remat\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         check=True, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == str(["RMSprop", "Adagrad", "Adadelta",
                                      "Adamax", "Nadam", "LARS", "LAMB",
                                      "LBFGS"])


def test_native_broker_source_is_the_ports_own_file():
    """The port builds its broker from its own copy of zbroker.cpp: a
    regular file under analytics_zoo_tpu_torch, not a link into the JAX
    package."""
    own = PKG / "serving" / "native" / "zbroker.cpp"
    jax_src = ROOT / "analytics_zoo_tpu" / "serving" / "native" / "zbroker.cpp"
    assert own.is_file() and not own.is_symlink()
    assert PKG.resolve() in own.resolve().parents
    assert not os.path.samefile(own, jax_src)
    from analytics_zoo_tpu_torch.serving import broker
    assert broker.NATIVE_SRC.resolve() == own.resolve()
    assert broker.BUILD_DIR == ROOT / "build" / "native"


NEW_IN_SLICE_21 = ("ops/autotune.py", "data/native_store.py",
                   "data/native/zstore.cpp", "friesian/__init__.py",
                   "friesian/feature/__init__.py",
                   "friesian/feature/table.py")


NEW_IN_SLICE_24 = ("common/protowire.py", "data/tfrecord.py",
                   "data/elastic_search.py", "data/image/__init__.py",
                   "data/image/parquet_dataset.py", "keras/autograd.py",
                   "keras2/__init__.py", "keras2/layers.py",
                   "nnframes/__init__.py", "nnframes/nn_classifier.py",
                   "learn/gan.py", "net/__init__.py", "net/net.py",
                   "net/torch_net.py", "net/onnx_net.py",
                   "net/openvino_net.py")


NEW_IN_SLICE_25 = ("analysis/__init__.py", "analysis/__main__.py",
                   "analysis/baseline.py", "analysis/cli.py",
                   "analysis/core.py", "analysis/ownership.py",
                   "analysis/report.py", "analysis/rules_catalog.py",
                   "analysis/rules_compile.py",
                   "analysis/rules_concurrency.py",
                   "analysis/rules_dataplane.py",
                   "analysis/rules_hotpath.py", "analysis/rules_jit.py",
                   "analysis/rules_lifecycle.py", "analysis/rules_locks.py",
                   "analysis/rules_ownership.py", "analysis/rules_taint.py")


@pytest.mark.parametrize("rel", NEW_IN_SLICE_21 + NEW_IN_SLICE_24
                         + NEW_IN_SLICE_25)
def test_new_sources_name_nothing_of_the_jax_package(rel):
    """The autotuner, the native store, Friesian, the readers, autograd,
    keras2, nnframes, the GAN, the model importers and zoolint are the
    port's own copies: no source names a module of the JAX package."""
    text = (PKG / rel).read_text()
    assert "analytics_zoo_tpu." not in text


def test_native_store_source_is_the_ports_own_file():
    """The port builds its native store from its own zstore.cpp into
    build/native, never from the JAX package's copy or build dir."""
    own = PKG / "data" / "native" / "zstore.cpp"
    jax_src = ROOT / "analytics_zoo_tpu" / "data" / "native" / "zstore.cpp"
    assert own.is_file() and not own.is_symlink()
    assert not os.path.samefile(own, jax_src)
    from analytics_zoo_tpu_torch.data import native_store
    assert native_store._SRC.resolve() == own.resolve()
    assert native_store.BUILD_DIR == ROOT / "build" / "native"


def test_pipeline_and_sharded_serving_import_without_jax():
    """Pipeline parallelism, ``from_fn`` and sharded serving load in a
    process that never saw JAX, and a pipelined MLP's sequential forward
    runs there."""
    code = (
        "import sys\n"
        "import torch\n"
        "from analytics_zoo_tpu_torch.learn.estimator import Estimator, "
        "FnModule\n"
        "from analytics_zoo_tpu_torch.parallel.pipeline import "
        "PipelinedMLP, PipelinedTransformerLM, gpipe, gpipe_hetero\n"
        "from analytics_zoo_tpu_torch.parallel.sharded_executable import "
        "ShardedExecutable\n"
        "m = PipelinedMLP(hidden=4, out_dim=2, n_stages=2)\n"
        "p = m.init(0, torch.zeros(1, 3))\n"
        "print(tuple(m.apply_sequential(p, torch.zeros(5, 3)).shape))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         check=True, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "(5, 2)"
