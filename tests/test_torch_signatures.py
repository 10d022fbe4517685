"""C25: the port's public signatures take every keyword the JAX package's
take, on the CPU.

The scan walks every module the two packages share (by dotted path under
each package) and, for each public function and each public method of a
public class defined there, checks that every parameter name of JAX's is
a parameter of the port's (or that the port's takes ``**kwargs``). The
stated exceptions live in ``EXCEPTIONS`` below, each with its reason:
the flax- and jax-only names, the
port's ground rule of no CPU failover, and JAX options that no caller in
either package needs and the port leaves out (a tile list where the
kernel has one tile, a timer prefix, a partial drain, an unused
``validation``, a forced rebuild). Also held: ``Estimator.from_torch``
with JAX's ``sample_input`` (checked on a CPU copy) and ``param_rules``
(JAX's rules, kept; a strategy needing more ranks than one process
raising, naming the ranks: ``"pp"`` trains across ranks,
``tests/test_torch_pipeline.py``), ``InferenceModel.load_torch(
torch_module=...)``, and JAX's keywords in ``Estimator.from_fn``,
``InferenceModel.shard`` and the pipeline functions; the
importers' and the new estimators' ``device`` beside JAX's keywords, and
``InferenceModel.load_openvino``. TorchNet, ONNXNet and OpenVINONet take
no ``jit``: the port runs torch, with nothing to compile.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

#: (module, public name) -> JAX parameter names the port does not take,
#: and why
EXCEPTIONS = {
    ("common.profiling", "backend_state"): (
        {"import_jax"}, "jax-only: the port has no jax to import"),
    ("common.resilience", "BackendSupervisor.__init__"): (
        {"import_jax"}, "jax-only: the port has no jax to import"),
    ("common.pipeline_io", "DevicePipeline.__init__"): (
        {"prefix"}, "unneeded: no caller in the port names its stages"),
    ("common.pipeline_io", "DevicePipeline.drain"): (
        {"max_n"}, "unneeded: no caller in the port retires part of the "
        "window"),
    ("common.resilience", "fault_drill"): (
        {"cpu_fallback"}, "no CPU failover (the port's ground rules)"),
    ("data.dataset", "to_sharded_dataset"): (
        {"validation"}, "unneeded: JAX's body never reads it"),
    ("inference.quantize", "calibrate_activations"): (
        {"apply_fn", "state"}, "flax-only: the port calibrates a module"),
    ("keras.layers", "KerasLayerWrapper.__init__"): (
        {"flax_module"}, "flax-only: the port wraps a torch module"),
    ("ops.autotune", "tune_attention"): (
        {"blocks"}, "the flash launcher has one tile per head dim "
        "(flash_attention.kernel_tile): there is no other to time"),
    ("parallel.sharded_executable", "ShardedExecutable.__init__"): (
        {"apply_fn"}, "the port's first argument is a module or a "
        "function (module_or_fn): a served model of the port is an "
        "nn.Module, JAX's a flax apply function"),
    ("serving.broker", "build_native_broker"): (
        {"force"}, "unneeded: the binary's name carries its source's "
        "digest, so a changed source builds anew"),
    ("net.torch_net", "TorchNet.__init__"): (
        {"jit"}, "jax-only: the port runs the module itself, there is "
        "no translation to jit"),
    ("net.onnx_net", "ONNXNet.__init__"): (
        {"jit"}, "jax-only: the graph runs op by op in torch, there is "
        "nothing to jit"),
    ("net.openvino_net", "OpenVINONet.__init__"): (
        {"jit"}, "jax-only: the IR runs layer by layer in torch, there "
        "is nothing to jit"),
}


def _flax_only(name, missing):
    """flax's own surface on the JAX side: ``Module.apply``'s variables and
    rngs, a dataclass module's ``parent`` / ``name``, a keras layer's
    ``apply(module, ...)`` over its flax module, a recurrent layer's flax
    cell class."""
    last = name.rsplit(".", 1)[-1]
    return (last == "apply" and missing <= {"module", "variables", "rngs",
                                            "method", "mutable",
                                            "capture_intermediates"}) \
        or (last == "__init__" and missing <= {"parent", "name"}) \
        or last == "cell_cls"


def _modules(pkg):
    out = {}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if m.name.endswith("__main__") or ".analysis" in m.name:
            continue
        try:
            out[m.name.split(".", 1)[1]] = importlib.import_module(m.name)
        except Exception:
            # a module needing a package this host lacks is not compared
            continue
    return out


def _params(fn):
    try:
        ps = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None, False
    names = {p.name for p in ps if p.kind not in (p.VAR_POSITIONAL,
                                                  p.VAR_KEYWORD)}
    return names - {"self", "cls"}, any(p.kind == p.VAR_KEYWORD for p in ps)


def _pairs(a, b):
    for attr in dir(a):
        if attr.startswith("_") or not hasattr(b, attr):
            continue
        fa, fb = getattr(a, attr), getattr(b, attr)
        if getattr(fa, "__module__", "") != a.__name__:
            continue
        if inspect.isclass(fa) and inspect.isclass(fb):
            yield attr + ".__init__", fa.__init__, fb.__init__
            for m in dir(fa):
                if m.startswith("_") or not hasattr(fb, m):
                    continue
                x, y = getattr(fa, m), getattr(fb, m)
                if callable(x) and callable(y):
                    yield f"{attr}.{m}", x, y
        elif callable(fa) and callable(fb):
            yield attr, fa, fb


@pytest.fixture(scope="module")
def gaps():
    pytest.importorskip("jax")
    import analytics_zoo_tpu
    import analytics_zoo_tpu_torch
    jm = _modules(analytics_zoo_tpu)
    tm = _modules(analytics_zoo_tpu_torch)
    found = {}
    for mod in sorted(set(jm) & set(tm)):
        for name, x, y in _pairs(jm[mod], tm[mod]):
            (want, _), (have, kwargs) = _params(x), _params(y)
            if want is None or have is None or kwargs:
                continue
            missing = want - have
            if missing and not _flax_only(name, missing):
                found[(mod, name)] = missing
    return found


def test_every_jax_keyword_is_taken_but_the_stated_exceptions(gaps):
    unexplained = {k: v for k, v in gaps.items()
                   if k not in EXCEPTIONS or not v <= EXCEPTIONS[k][0]}
    assert unexplained == {}


@pytest.mark.parametrize("key", sorted(EXCEPTIONS),
                         ids=[f"{m}:{n}" for m, n in sorted(EXCEPTIONS)])
def test_each_exception_is_still_a_gap(gaps, key):
    """An exception that no longer applies is taken off the list."""
    assert gaps.get(key) == EXCEPTIONS[key][0]


@pytest.mark.parametrize("module, name, keywords", [
    ("learn.estimator", "Estimator.from_torch", {"sample_input",
                                                 "param_rules"}),
    ("inference.inference_model", "InferenceModel.load_torch",
     {"torch_module", "sample_input"}),
    ("ops.embedding_bag", "fused_embedding_lookup", {"use_kernel"}),
    ("ops.embedding_bag", "embedding_bag", {"use_kernel"}),
    ("ops.paged_attention", "paged_gather", {"use_kernel"}),
    ("ops.paged_attention", "paged_attention", {"use_kernel"}),
    ("ops.flash_attention", "flash_attention", {"block_q", "block_k"}),
    ("learn.estimator", "TorchEstimator.predict", {"pipeline_window"}),
    ("learn.estimator", "Estimator.from_fn",
     {"apply_fn", "params", "loss", "optimizer", "metrics", "n_inputs",
      "model_dir", "strategy", "param_rules", "seed"}),
    ("inference.inference_model", "InferenceModel.shard",
     {"strategy", "param_rules", "mesh", "devices"}),
    ("parallel.pipeline", "gpipe",
     {"stage_fn", "stacked_params", "x", "mesh", "n_microbatches", "axis"}),
    ("parallel.pipeline", "gpipe_hetero",
     {"stage_fns", "unravels", "sizes", "packed", "feed", "mesh",
      "n_microbatches", "act_shape", "out_shape", "act_dtype", "out_dtype",
      "axis"}),
    ("parallel.sharded_executable", "ShardedExecutable.warm",
     {"spec", "rungs", "block", "cpu_also"}),
    ("inference.inference_model", "InferenceModel.load_openvino",
     {"model_path", "weight_path", "batch_size"}),
    ("net.net", "Net.load_torch", {"module", "device"}),
    ("net.net", "Net.load_onnx", {"path", "device"}),
    ("net.net", "Net.load_openvino", {"model_path", "weight_path",
                                      "device"}),
    ("net.torch_net", "TorchNet", {"module", "device"}),
    ("learn.gan", "GANEstimator",
     {"generator", "discriminator", "noise_dim", "generator_optimizer",
      "discriminator_optimizer", "loss", "seed", "device"}),
    ("nnframes.nn_classifier", "NNEstimator",
     {"model", "loss", "optimizer", "feature_preprocessing",
      "label_preprocessing", "device"}),
    ("keras.autograd", "batch_dot", {"x", "y", "axes"}),
    ("data.image.parquet_dataset", "ParquetDataset.write",
     {"path", "generator", "schema", "block_size", "write_mode"}),
])
def test_c25_keywords_present(module, name, keywords):
    mod = importlib.import_module(f"analytics_zoo_tpu_torch.{module}")
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    assert keywords <= set(inspect.signature(obj).parameters)


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 2)

    def forward(self, x):
        return self.lin(x)


def test_from_torch_takes_sample_input_and_param_rules():
    from analytics_zoo_tpu_torch.learn import Estimator
    model = _MLP()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    est = Estimator.from_torch(model=model, loss="mse", optimizer="adam",
                               sample_input=np.zeros((2, 4), np.float32),
                               device="cpu")
    assert est.model is model
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])          # the probe ran on a copy
    with pytest.raises(ValueError, match="sample_input"):
        Estimator.from_torch(model=_MLP(), loss="mse",
                             sample_input=np.zeros((2, 3), np.float32),
                             device="cpu")
    # JAX's rules are taken (flax's paths: an nn.Linear is a Dense); on
    # one rank nothing divides over "model"
    rules = [(r"lin/kernel", (None, "model"))]
    est = Estimator.from_torch(model=_MLP(), loss="mse", param_rules=rules,
                               device="cpu")
    assert est.strategy.param_rules == rules and est._shards == {}
    # one process is one rank: two pipe stages need two ranks
    with pytest.raises(ValueError, match="ranks"):
        Estimator.from_torch(model=_MLP(), loss="mse", strategy="pp2",
                             device="cpu")


def test_flash_attention_takes_only_the_kernel_tile():
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    q = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, 2, 16)).astype(np.float32))
    want = tfa.flash_attention(q, q, q)
    bq, bk = tfa.kernel_tile(16)
    for kw in (dict(block_q=bq), dict(block_k=bk),
               dict(block_q=bq, block_k=bk)):
        assert torch.equal(tfa.flash_attention(q, q, q, **kw), want)
        assert torch.equal(tfa.flash_attention_with_lse(q, q, q, **kw)[0],
                           want)
    for kw in (dict(block_q=bq // 2), dict(block_k=2 * bk)):
        with pytest.raises(ValueError, match="tile"):
            tfa.flash_attention(q, q, q, **kw)
        with pytest.raises(ValueError, match="tile"):
            tfa.flash_attention_with_lse(q, q, q, **kw)


def test_load_torch_takes_torch_module_by_keyword():
    from analytics_zoo_tpu_torch.inference import InferenceModel
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    model = _MLP()
    im = InferenceModel(device="cpu").load_torch(torch_module=model,
                                                 sample_input=x)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(im.predict(x), want)
