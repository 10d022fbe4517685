"""``ImageClassifier`` in the port against the JAX package's, on the CPU.

Both packages build the same graph for a ``model_name``; the JAX model's
initial parameters and ``batch_stats`` go through ``convert.py`` into the
port's module. Held:

- ``resnet-lite`` at 32 px, ``lenet`` at 28 and ``squeezenet`` at 64
  (class_num 3): the eval-mode predict within 1e-5 (measured: at most
  3.9e-7);
- ``resnet-lite`` fit for 2 epochs at batch 8 (32 rows, 8 steps, shuffled
  in the JAX package's order; JAX on its 8 virtual devices), from the
  same weights:
  - with SGD, the loss of each epoch within rtol 1e-5 and every parameter
    and running statistic within 1e-5 (measured: 1.2e-7 relative; 6.0e-7
    and 2.4e-7);
  - with Adam (lr 1e-3), the loss of each epoch within rtol 2e-3
    (measured: 1.3e-4), every parameter within 2 lr a step (measured:
    9.5e-3 of 1.6e-2) and every running statistic within 2e-3
    (measured: 4.4e-4). The loose Adam limits have a cause: the biases
    of the convolutions that feed a batch norm have a zero gradient in
    exact arithmetic (the norm subtracts the batch mean), so both
    packages' gradients there are rounding noise (2.5e-7 against 0.1
    elsewhere; the first step's gradients agree within 5e-7), and Adam,
    which divides by the gradient's own magnitude, moves each such bias
    by about lr a step in a direction the noise picks. The runs then
    drift apart as the biases shift the norms' inputs; SGD shows the
    step itself agrees;
- ResNet-50's parameter and ``batch_stats`` trees equal JAX's in names
  and shapes (``jax.eval_shape`` of its init at 224 px: nothing is
  computed), with 23-26 M parameters (JAX tests/test_model_zoo.py);
- ResNet-50's whole forward at 32 px against JAX within 1e-5 (about 6 s
  on one core);
- without CUDA and without ``device="cpu"``, predict and fit raise;
- every ported architecture's output shape at 64 px, ``predict_classes``,
  ``save_model``/``load_model`` with the running statistics, and the
  errors naming ROADMAP A11 (``mobilenet``, ``inception-v1``,
  ``mobilenet-v2``, ``predict_image_set``) and ``migration_image``
  (``pretrained=``).

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (ParamLayout, flatten,
                                             flax_layout, flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.models import ImageClassifier, ZooModel

LOSS = "sparse_categorical_crossentropy"
SIZE, CLASSES, ROWS, BATCH, EPOCHS = 32, 3, 32, 8, 2
LR = 1e-3


@pytest.fixture(autouse=True)
def _setup(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
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


def _data(n=ROWS, size=SIZE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, size, size, 3)).astype(np.float32),
            rng.integers(0, CLASSES, n).astype(np.int32))


def _variables(jx, jclf, optimizer="adam"):
    jclf.compile(optimizer=optimizer, loss=LOSS)
    adapter = jclf.model._ensure_estimator().adapter
    return (jx["jax"].device_get(adapter.params),
            jx["jax"].device_get(adapter.model_state))


def _port_like(params, model_state, **kw):
    clf = ImageClassifier(**kw)
    sd = flax_to_state_dict(params)
    sd.update(flax_to_state_dict(model_state.get("batch_stats", {})))
    clf.model.module.load_state_dict(sd, strict=True)
    return clf


@pytest.mark.parametrize("name,size", [("resnet-lite", SIZE),
                                       ("lenet", 28), ("squeezenet", 64)])
def test_predict_matches_jax(jx, name, size):
    """resnet-lite's norms and residual sums, lenet's Flatten (HWC order,
    as JAX flattens NHWC) and squeezenet's valid pools and concats."""
    kw = dict(class_num=CLASSES, model_name=name, image_size=size)
    jclf = jx["IC"](**kw)
    params, state = _variables(jx, jclf)
    assert sorted(state) == (["batch_stats"] if name == "resnet-lite"
                             else [])
    x, _ = _data(8, size=size)
    want = np.asarray(jclf.predict(x, batch_size=8))
    clf = _port_like(params, state, **kw)
    got = clf.predict(x, batch_size=8, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        clf.predict_classes(x, batch_size=8, device="cpu"), got.argmax(-1))


#: optimizer -> (loss rtol, parameter atol, running-statistic atol)
FIT_LIMITS = {"sgd": (1e-5, 1e-5, 1e-5),
              "adam": (2e-3, 2 * LR * EPOCHS * (ROWS // BATCH), 2e-3)}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_resnet_lite_fit_matches_jax(jx, optimizer):
    kw = dict(class_num=CLASSES, model_name="resnet-lite", image_size=SIZE)
    jclf = jx["IC"](**kw)
    params, state = _variables(jx, jclf, optimizer)
    clf = _port_like(params, state, **kw)
    clf.compile(optimizer=optimizer, loss=LOSS, device="cpu")
    x, y = _data()
    want = jclf.fit(x, y, batch_size=BATCH, nb_epoch=EPOCHS)
    got = clf.fit(x, y, batch_size=BATCH, nb_epoch=EPOCHS)
    loss_rtol, p_atol, s_atol = FIT_LIMITS[optimizer]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    jstate = jclf.model._estimator._state
    jp = jx["jax"].device_get(jstate["params"])
    tree = clf.model.estimator._state_tree()
    got_p = flatten(tree["params"])
    for k, v in flatten(jp).items():
        np.testing.assert_allclose(got_p[k], v, rtol=0, atol=p_atol,
                                   err_msg=k)
    got_s = flatten(tree["model_state"])
    want_s = flatten(jx["jax"].device_get(jstate["model_state"]))
    assert sorted(got_s) == sorted(want_s)
    for k, v in want_s.items():
        np.testing.assert_allclose(np.asarray(got_s[k]), v, rtol=0,
                                   atol=s_atol, err_msg=k)


def test_resnet50_trees_match_jax_in_names_and_shapes(jx):
    jax = jx["jax"]
    jclf = jx["IC"](class_num=2, model_name="resnet-50", image_size=224)
    module = jclf.model.to_flax()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            np.zeros((1, 224, 224, 3), np.float32)))
    want = {k: tuple(v.shape) for k, v in flatten(
        jax.tree_util.tree_map(lambda a: a, dict(shapes))).items()}
    clf = ImageClassifier(class_num=2, model_name="resnet-50",
                          image_size=224)
    mod = clf.model.module
    got = {f"params.{k}": tuple(v.shape)
           for k, v in flatten(flax_layout(mod)).items()}
    buffers = dict(mod.named_buffers())
    got.update({f"{k}": tuple(v.shape) for k, v in flatten(
        ParamLayout(mod).state_tree(buffers)).items()})
    assert got == want
    n = sum(p.numel() for p in mod.parameters())
    assert 23e6 < n < 26e6
    assert sum(k.startswith("batch_stats.") for k in got) == 2 * 53


def test_resnet50_forward_matches_jax(jx):
    kw = dict(class_num=4, model_name="resnet-50", image_size=SIZE)
    jclf = jx["IC"](**kw)
    params, state = _variables(jx, jclf)
    x, _ = _data(8)
    want = np.asarray(jclf.predict(x, batch_size=8))
    got = _port_like(params, state, **kw).predict(x, batch_size=8,
                                                  device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["lenet", "vgg-lite", "resnet-lite",
                                  "alexnet", "vgg-16", "vgg-19",
                                  "resnet-50", "squeezenet",
                                  "densenet-121", "densenet-161"])
def test_every_ported_architecture_forwards_at_64px(name):
    clf = ImageClassifier(class_num=5, model_name=name, image_size=64)
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    out = clf.predict(x, batch_size=1, device="cpu")
    assert out.shape == (1, 5) and np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)


def test_mixed_bfloat16_builds_bf16_layers_with_fp32_parameters():
    clf = ImageClassifier(class_num=2, model_name="resnet-lite",
                          image_size=SIZE, dtype="mixed_bfloat16")
    mod = clf.model.module
    assert all(p.dtype == torch.float32 for p in mod.parameters())
    assert all(b.dtype == torch.float32 for b in mod.buffers())
    assert mod.conv2d_1.compute_dtype == torch.bfloat16
    assert mod.batchnormalization_1.compute_dtype == torch.bfloat16
    out = clf.predict(_data(2)[0], batch_size=2, device="cpu")
    assert out.shape == (2, 2) and np.isfinite(out).all()


def test_save_and_load_model_keep_the_running_statistics(tmp_path):
    clf = ImageClassifier(class_num=CLASSES, model_name="resnet-lite",
                          image_size=SIZE)
    clf.compile(optimizer="adam", loss=LOSS, device="cpu")
    x, y = _data()
    clf.fit(x, y, batch_size=BATCH, nb_epoch=1)
    clf.save_model(str(tmp_path / "m"))
    back = ZooModel.load_model(str(tmp_path / "m"))
    assert isinstance(back, ImageClassifier)
    assert back._config() == clf._config()
    want = clf.model.module.state_dict()
    for k, v in back.model.module.state_dict().items():
        assert torch.equal(v, want[k]), k
    back.compile(optimizer="adam", loss=LOSS, device="cpu")
    np.testing.assert_array_equal(back.predict(x[:4], batch_size=4),
                                  clf.predict(x[:4], batch_size=4))


def test_the_card_is_the_default_device():
    """Without CUDA and without an explicit CPU device, predict and fit
    raise; ``device="cpu"`` runs."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device runs")
    clf = ImageClassifier(class_num=2, model_name="lenet", image_size=28)
    x, y = _data(4, size=28)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clf.predict(x, batch_size=4)
    clf.compile(optimizer="adam", loss=LOSS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clf.fit(x, y % 2, batch_size=4)
    clf.compile(optimizer="adam", loss=LOSS, device="cpu")
    assert clf.predict(x, batch_size=4).shape == (4, 2)


@pytest.mark.parametrize("name,layer", [("mobilenet", "SeparableConv2D"),
                                        ("inception-v1", "LRN2D"),
                                        ("mobilenet-v2", "grouped")])
def test_unported_architectures_name_roadmap_a11(name, layer):
    with pytest.raises(ValueError, match=f"{layer}.*ROADMAP A11"):
        ImageClassifier(class_num=2, model_name=name)


def test_unknown_name_pretrained_and_image_sets_are_refused():
    with pytest.raises(ValueError, match="unknown model_name"):
        ImageClassifier(class_num=2, model_name="resnet-18")
    with pytest.raises(NotImplementedError, match="migration_image"):
        ImageClassifier(class_num=2, model_name="resnet-lite",
                        pretrained={})
    clf = ImageClassifier(class_num=2, model_name="lenet", image_size=28)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        clf.predict_image_set(object())


def test_state_dict_round_trips_through_the_flax_trees():
    clf = ImageClassifier(class_num=2, model_name="resnet-lite",
                          image_size=SIZE)
    mod = clf.model.module
    layout = ParamLayout(mod)
    params = state_dict_to_flax(mod.state_dict(), layout.like)
    stats = layout.state_tree({k: v for k, v in mod.named_buffers()})
    sd = flax_to_state_dict(params)
    sd.update(flax_to_state_dict(stats["batch_stats"]))
    for k, v in mod.state_dict().items():
        assert torch.equal(sd[k], v), k
