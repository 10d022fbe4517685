"""Where writing the port's examples (``examples_torch/``) met the port's
public surface, against the JAX package's (ROADMAP C35-C38).

- C35: every name a JAX package's ``__init__.py`` binds is there in the
  port's package of the same path (read from JAX's source, so JAX is not
  imported), but for the JAX translators whose port counterparts carry
  torch's name. ``image_classification_serving`` imports
  ``serving.image_pipeline``, which the port's ``serving`` lacked.
- C36 (settled): ranks that share one card make their gloo group
  themselves, as ``multihost_launch``'s workers and
  ``parallel/launch.py``'s ranks do, and ``init_orca_context(cluster_mode=
  "multihost", device="cuda:0")`` adopts it; a group the context makes
  itself on a card is NCCL, and two ranks on one card still raise naming
  both counts.
- C37 (settled): ``Estimator.from_torch`` trains the module it is given,
  where JAX trains a translated copy and leaves the module as it was;
  ``torch_migration`` then serves the trained module.
- C38 (open): ``stop_orca_context`` waits for the ranks of a gloo group
  it made, at most ``TEARDOWN_WAIT`` seconds (a monitored barrier), before
  it destroys the group; an NCCL group it destroys at once, a group it
  adopted it leaves alone.
"""

import ast
import importlib
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: names a JAX ``__init__`` binds that the port spells otherwise, with
#: the port's name: the translators into JAX become the port's into torch
RENAMED = {"analytics_zoo_tpu.net": {"onnx_to_jax": "onnx_to_torch",
                                     "openvino_to_jax": "openvino_to_torch",
                                     "torch_to_jax": "swap_attention"}}


def _bound_names(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_") and n != "*"}


def _jax_packages():
    root = os.path.join(REPO, "analytics_zoo_tpu")
    for dirpath, _, files in os.walk(root):
        if "__init__.py" in files and "__pycache__" not in dirpath:
            rel = os.path.relpath(dirpath, REPO)
            yield rel.replace(os.sep, ".")


@pytest.mark.parametrize("package", sorted(_jax_packages()))
def test_c35_package_binds_jax_names(package):
    path = os.path.join(REPO, *package.split("."), "__init__.py")
    names = _bound_names(path)
    port = importlib.import_module(
        package.replace("analytics_zoo_tpu", "analytics_zoo_tpu_torch", 1))
    renamed = RENAMED.get(package, {})
    missing = sorted(n for n in names
                     if not hasattr(port, renamed.get(n, n)))
    assert missing == [], f"{port.__name__} lacks {missing}"


def test_c35_image_classification_serving_imports():
    from analytics_zoo_tpu_torch.serving import ServingConfig, image_pipeline
    from analytics_zoo_tpu_torch.serving import engine, config
    assert image_pipeline is engine.image_pipeline
    assert ServingConfig is config.ServingConfig
    assert callable(image_pipeline("resnet-50", source="torchvision"))


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, backend, **kw):
        self.calls.append((backend, kw))


@pytest.fixture
def fake_card(monkeypatch):
    """One card that is not there: the group's constructor recorded, not
    run."""
    import torch.distributed as dist
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", rec)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    return rec


def test_c36_context_adopts_a_gloo_group_on_one_card(fake_card,
                                                     monkeypatch):
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.common import context
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    for rank in (0, 1):
        monkeypatch.setattr(dist, "get_rank", lambda: rank)
        got = context._join_ranks("127.0.0.1:1234", 2, rank, "cuda:0")
        assert got == (torch.device("cuda", 0), False, 2, rank)
    assert fake_card.calls == []


def test_c36_nccl_still_refuses_two_ranks_on_one_card(fake_card):
    from analytics_zoo_tpu_torch.common import context
    with pytest.raises(ValueError, match="local rank 1 on a host with 1.*"
                       "make the process group yourself"):
        context._join_ranks("127.0.0.1:1234", 2, 1, "cuda:0")
    assert fake_card.calls == []


def test_c37_from_torch_trains_the_module_it_is_given(tmp_path, monkeypatch):
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.learn import estimator
    from analytics_zoo_tpu_torch.learn.estimator import Estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path))
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(0)
    x = rng.randn(256, 4).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    est = Estimator.from_torch(
        model=model, loss="sparse_categorical_crossentropy_logits",
        optimizer="adam", sample_input=x[:2], device="cpu")
    est.fit((x, y), epochs=2, batch_size=32)
    trained = est.get_model().state_dict()
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k
        assert torch.equal(v, trained[k]), k
    served = InferenceModel(device="cpu").load_torch(model, x[:1]) \
        .predict_classes(x[:16])
    want = est.predict(x[:16], batch_size=16).argmax(-1)
    np.testing.assert_array_equal(served, want)


def _teardown(monkeypatch, made, backend, barrier=None):
    """``stop_orca_context`` on a context whose group (``backend``) it
    made or adopted; the calls it made on ``torch.distributed``."""
    import torch.distributed as dist
    from analytics_zoo_tpu_torch.common import context
    calls = []

    def monitored(timeout):
        calls.append(("barrier", timeout.total_seconds()))
        if barrier is not None:
            raise barrier
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda: backend)
    monkeypatch.setattr(dist, "monitored_barrier", monitored)
    monkeypatch.setattr(dist, "barrier", lambda: calls.append("unbounded"))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: calls.append("destroy"))
    ctx = context.ZooTpuContext("multihost", None, [torch.device("cpu")],
                                num_processes=2, process_index=1)
    ctx.owns_group = made
    monkeypatch.setattr(context, "_active_context", ctx)
    context.stop_orca_context()
    assert context.active_context() is None
    return calls


@pytest.mark.parametrize("made,backend", [(True, "gloo"), (True, "nccl"),
                                          (False, "gloo")])
def test_c38_stop_waits_for_the_ranks_before_dropping_its_group(
        monkeypatch, made, backend):
    from analytics_zoo_tpu_torch.common import context
    calls = _teardown(monkeypatch, made, backend)
    want = {(True, "gloo"): [("barrier", context.TEARDOWN_WAIT), "destroy"],
            (True, "nccl"): ["destroy"], (False, "gloo"): []}
    assert calls == want[made, backend]


def test_c38_teardown_does_not_wait_past_its_bound(monkeypatch, caplog):
    """A peer that never reaches the teardown (an error path) costs at
    most the bound: the barrier's timeout is logged and the group still
    goes."""
    from analytics_zoo_tpu_torch.common import context
    assert context.TEARDOWN_WAIT <= 30
    calls = _teardown(monkeypatch, True, "gloo",
                      barrier=RuntimeError("Rank 0 timed out"))
    assert calls == [("barrier", context.TEARDOWN_WAIT), "destroy"]
    assert "ranks missing at teardown" in caplog.text
