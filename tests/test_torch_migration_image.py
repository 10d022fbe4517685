"""torchvision-layout weight import into the port's ``ImageClassifier``
(``models/migration_image.py``), on the CPU.

Each twin (``MAKE_TWINS``, plain ``torch.nn`` modules whose state dict
keys are torchvision's) gets weights from a seed and distinctive batch
norm statistics (running mean and variance, scale and bias drawn away
from their initial values, so an import that dropped them would show),
and ``ImageClassifier(pretrained=...)`` must reproduce it in eval mode:

- ``resnet-50``, ``mobilenet-v2``, ``squeezenet`` and ``densenet-121``
  at 64 px, ``alexnet`` at 224 with batch 1 (its classifier's first
  linear takes torch's CHW flatten, permuted to the port's HWC): the
  probabilities within 1e-4 of the twin's softmax, as JAX's
  tests/test_migration_image.py holds them, and, since random weights
  can make the softmax near one-hot, the last layer's logits within 1e-4
  of their largest magnitude too (measured: the probabilities equal;
  the logits equal but for alexnet's, 1.8e-7 of their largest, whose
  permuted first linear sums in another order), top-1 equal;
- the same state dict imported by both packages gives equal parameter
  and ``batch_stats`` trees, bitwise, for ``resnet-50`` and
  ``mobilenet-v2``;
- JAX's other cases (tests/test_migration_image.py:59-129):
  ``pretrained=`` taking a ``torch.save`` path, a dict and a module; the
  running statistics landing in ``batch_stats``; ``inception-v1`` refused
  with JAX's words and a class count that differs refused as a shape
  error; the checked-in ``img0.png`` through the torchvision preset into
  the imported ResNet-50 at 224;
- ``migration.py``'s NCF and Wide&Deep twins imported within 1e-5 of the
  twin, and ``assign_layer_params`` refusing unknown layers, leaves and
  shapes.

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (ParamLayout, flatten,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.models import ImageClassifier
from analytics_zoo_tpu_torch.models.migration_image import (
    MAKE_TWINS, import_image_classifier_from_torch,
)

TOL = 1e-4
CLASSES = 7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from analytics_zoo_tpu.models.image.imageclassification import (
        ImageClassifier as JImageClassifier,
    )
    return dict(jax=jax, IC=JImageClassifier)


def _twin(name, classes=CLASSES, seed=0):
    """The twin with weights from ``seed`` and batch norms moved off their
    initial state."""
    torch.manual_seed(seed)
    twin = MAKE_TWINS[name](classes).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
    return twin


def _x(size, batch, seed=0):
    return (np.random.RandomState(seed).rand(batch, size, size, 3)
            .astype(np.float32) * 2 - 1)


def _logits(clf, x):
    """The eval forward's probabilities and the logits its last Dense (or
    the last conv's relu, pooled: squeezenet's head) computes."""
    mod = clf.model.module.eval()
    from analytics_zoo_tpu_torch.common.flax_compat import Conv, Dense
    last = [m for m in mod.modules() if isinstance(m, (Dense, Conv))][-1]
    seen = []
    hook = last.register_forward_hook(lambda m, a, out: seen.append(out))
    try:
        with torch.no_grad():
            probs = mod(torch.from_numpy(x)).numpy()
    finally:
        hook.remove()
    out = seen[0]
    if out.dim() == 4:
        out = torch.relu(out).mean((1, 2))
    return probs, out.numpy()


def _parity(name, size, batch=2, pretrained=None, twin=None):
    twin = twin if twin is not None else _twin(name)
    clf = ImageClassifier(CLASSES, name, image_size=size,
                          pretrained=twin if pretrained is None
                          else pretrained)
    x = _x(size, batch)
    with torch.no_grad():
        logits = twin(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    want = torch.softmax(torch.from_numpy(logits), -1).numpy()
    probs, got_logits = _logits(clf, x)
    np.testing.assert_allclose(probs, want, rtol=0, atol=TOL)
    scale = float(np.abs(logits).max())
    assert float(np.abs(got_logits - logits).max()) <= TOL * scale
    np.testing.assert_array_equal(probs.argmax(-1), want.argmax(-1))
    return clf, twin


@pytest.mark.parametrize("name,size,batch", [
    ("resnet-50", 64, 2), ("mobilenet-v2", 64, 2), ("squeezenet", 64, 2),
    ("densenet-121", 64, 2), ("alexnet", 224, 1)])
def test_import_reproduces_the_twin(name, size, batch):
    _parity(name, size, batch)


@pytest.mark.parametrize("name", ["resnet-50", "mobilenet-v2"])
def test_both_packages_import_to_equal_trees(jx, name):
    twin = _twin(name, seed=3)
    sd = twin.state_dict()
    jclf = jx["IC"](class_num=CLASSES, model_name=name, image_size=64,
                    pretrained=sd)
    adapter = jclf.model._ensure_estimator().adapter
    want_p = flatten(jx["jax"].device_get(adapter.params))
    want_s = flatten(jx["jax"].device_get(
        adapter.model_state["batch_stats"]))
    clf = ImageClassifier(CLASSES, name, image_size=64, pretrained=sd)
    mod = clf.model.module
    layout = ParamLayout(mod)
    got_p = flatten(state_dict_to_flax(mod.state_dict(), layout.like))
    got_s = flatten(layout.state_tree(dict(mod.named_buffers()))[
        "batch_stats"])
    for got, want in ((got_p, want_p), (got_s, want_s)):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(v), err_msg=k)


def test_pretrained_takes_a_path_a_dict_and_a_module(tmp_path):
    twin = _twin("resnet-50", seed=5)
    path = str(tmp_path / "resnet50.pt")
    torch.save(twin.state_dict(), path)
    for pre in (path, twin.state_dict(), twin):
        _parity("resnet-50", 64, batch=1, pretrained=pre, twin=twin)


def test_running_statistics_land_in_batch_stats():
    twin = _twin("resnet-50", classes=4, seed=6)
    sd = twin.state_dict()
    sd["bn1.running_mean"] += 0.7
    twin.load_state_dict(sd)
    clf = ImageClassifier(4, "resnet-50", image_size=64, pretrained=twin)
    mod = clf.model.module
    stats = ParamLayout(mod).state_tree(dict(mod.named_buffers()))
    bn1 = stats["batch_stats"]["batchnormalization_1"]
    np.testing.assert_array_equal(bn1["mean"].numpy(),
                                  sd["bn1.running_mean"].numpy())
    np.testing.assert_array_equal(bn1["var"].numpy(),
                                  sd["bn1.running_var"].numpy())


def test_unsupported_architectures_and_shapes_are_refused():
    with pytest.raises(ValueError, match="inception-v1 excluded"):
        ImageClassifier(5, "inception-v1", image_size=64, pretrained={})
    twin = MAKE_TWINS["squeezenet"](10).eval()
    clf = ImageClassifier(5, "squeezenet", image_size=64)
    before = {k: v.clone() for k, v in clf.model.module.state_dict().items()}
    with pytest.raises(ValueError, match="shape"):
        import_image_classifier_from_torch(clf, twin)
    # nothing was written: every array is checked before any lands
    for k, v in clf.model.module.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_real_image_through_the_torchvision_preset():
    from PIL import Image

    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        image_classifier as ic,
    )
    img = np.asarray(Image.open(
        "tests/fixtures/detection/img0.png").convert("RGB"), np.float32)
    x = ic.preprocessor("resnet-50", source="torchvision").transform(
        {"image": img})["image"][None]
    assert x.shape == (1, 224, 224, 3)
    twin = _twin("resnet-50", seed=8)
    clf = ImageClassifier(CLASSES, "resnet-50", image_size=224,
                          pretrained=twin)
    with torch.no_grad():
        want = torch.softmax(twin(torch.from_numpy(
            x.transpose(0, 3, 1, 2))), -1).numpy()
    got = clf.predict(x, batch_size=1, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert int(got.argmax()) == int(want.argmax())


# ---- migration.py: the NCF and Wide&Deep twins ----

def test_ncf_twin_imports():
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.models.migration import (
        import_ncf_from_torch, make_torch_ncf,
    )
    torch.manual_seed(0)
    twin = make_torch_ncf(30, 20, 4, user_embed=6, item_embed=5,
                          hidden_layers=(12, 8), mf_embed=4).eval()
    ncf = NeuralCF(30, 20, 4, user_embed=6, item_embed=5,
                   hidden_layers=(12, 8), mf_embed=4)
    import_ncf_from_torch(ncf, twin)
    rng = np.random.RandomState(0)
    x = np.stack([rng.randint(1, 31, 16), rng.randint(1, 21, 16)], 1)
    with torch.no_grad():
        want = twin(torch.from_numpy(x)).numpy()
    got = ncf.predict(x.astype(np.float32), batch_size=16, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_wide_and_deep_twin_imports():
    from analytics_zoo_tpu_torch.models import (ColumnFeatureInfo,
                                                WideAndDeep)
    from analytics_zoo_tpu_torch.models.migration import (
        import_wide_and_deep_from_torch, make_torch_wide_and_deep,
    )
    info = ColumnFeatureInfo(
        wide_base_cols=["a", "b"], wide_base_dims=[5, 4],
        wide_cross_cols=["ab"], wide_cross_dims=[6],
        indicator_cols=["c"], indicator_dims=[3],
        embed_cols=["u", "v"], embed_in_dims=[10, 8],
        embed_out_dims=[4, 3], continuous_cols=["x", "y"])
    torch.manual_seed(1)
    twin = make_torch_wide_and_deep(3, info, hidden_layers=(8, 6)).eval()
    wnd = WideAndDeep(3, info, model_type="wide_n_deep",
                      hidden_layers=(8, 6))
    import_wide_and_deep_from_torch(wnd, twin)
    rng = np.random.RandomState(2)
    n = 12
    wide = np.zeros((n, 15), np.float32)
    wide[np.arange(n), rng.randint(0, 15, n)] = 1.0
    ind = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    emb = np.stack([rng.randint(0, 11, n), rng.randint(0, 9, n)], 1)
    con = rng.randn(n, 2).astype(np.float32)
    with torch.no_grad():
        want = twin(*(torch.from_numpy(a) for a in
                      (wide, ind, emb, con))).numpy()
    got = wnd.predict([wide, ind, emb.astype(np.float32), con],
                      batch_size=n, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_assign_layer_params_refuses_what_the_model_lacks():
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.models.migration import assign_layer_params
    ncf = NeuralCF(5, 5, 2, hidden_layers=(4,))
    with pytest.raises(KeyError, match="not in model"):
        assign_layer_params(ncf.model, {"dense_9": {"kernel": np.zeros(1)}})
    with pytest.raises(KeyError, match="no param"):
        assign_layer_params(ncf.model, {"dense_1": {"scale": np.zeros(4)}})
    with pytest.raises(ValueError, match="shape"):
        assign_layer_params(ncf.model,
                            {"dense_1": {"kernel": np.zeros((3, 4))}})
    with pytest.raises(KeyError, match="batch_stats"):
        assign_layer_params(ncf.model, {}, {"dense_1": {"mean": np.zeros(4)}})
