"""``ImageClassifier`` in the port against the JAX package's, on the CPU.

Both packages build the same graph for a ``model_name``; the JAX model's
initial parameters and ``batch_stats`` go through ``convert.py`` into the
port's module. Held:

- ``resnet-lite`` at 32 px, ``lenet`` at 28, ``squeezenet`` at 64 and
  ``mobilenet`` (its ``SeparableConv2D``), ``inception-v1`` (its
  ``LRN2D``) and ``mobilenet-v2`` (its grouped depthwise convolutions)
  at 32 (class_num 3): the eval-mode predict within 1e-5 (measured: at
  most 3.9e-7);
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
- ``mobilenet-v2``'s training step and one fit step against JAX's, its
  head's dropout at rate 0 in both packages (they draw their masks from
  different generators, as tests/test_torch_zoo_models.py notes), held
  to the port's float64 step since fp32 rounding is amplified there (the
  test's docstring);
- ResNet-50's parameter and ``batch_stats`` trees equal JAX's in names
  and shapes (``jax.eval_shape`` of its init at 224 px: nothing is
  computed), with 23-26 M parameters (JAX tests/test_model_zoo.py);
- ResNet-50's whole forward at 32 px against JAX within 1e-5 (about 6 s
  on one core);
- mobilenet-v2's parameter count JAX's, and within JAX's band
  (tests/test_model_zoo.py:504);
- without CUDA and without ``device="cpu"``, predict and fit raise;
- every architecture's output shape at 64 px, ``predict_classes``,
  ``save_model``/``load_model`` with the running statistics, the layers
  each of ``mobilenet``, ``inception-v1`` and ``mobilenet-v2`` is built
  of, ``predict_image_set`` equal to ``predict`` on the set's images, and
  the refusals (an unknown name, ``pretrained=`` for an architecture
  without a torchvision mapping).

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
                                       ("lenet", 28), ("squeezenet", 64),
                                       ("mobilenet", SIZE),
                                       ("inception-v1", SIZE),
                                       ("mobilenet-v2", SIZE)])
def test_predict_matches_jax(jx, name, size):
    """resnet-lite's norms and residual sums, lenet's Flatten (HWC order,
    as JAX flattens NHWC), squeezenet's valid pools and concats,
    mobilenet's separable convolutions, inception-v1's LRN and branch
    concats and mobilenet-v2's depthwise convolutions and relu6."""
    kw = dict(class_num=CLASSES, model_name=name, image_size=size)
    jclf = jx["IC"](**kw)
    params, state = _variables(jx, jclf)
    assert sorted(state) == (["batch_stats"] if name in (
        "resnet-lite", "mobilenet-v2") else [])
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


def _graph_layers(model):
    from analytics_zoo_tpu_torch.keras.engine import topo_sort
    return [n.layer for n in topo_sort(list(model._outputs))
            if n.layer is not None]


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


#: mobilenet-v2's step against JAX's (the docstring of the test below);
#: the readings beside each
MNV2_LOSS_RTOL = 2e-4           # fp32 loss vs float64: port 1.6e-6, JAX 3.3e-5
MNV2_OVER_PORT = 1.5            # JAX's gradient 0.0186 of the norm from
#                                 float64, the port's own fp32 0.0162
MNV2_HEAD_RTOL = 1e-3           # the Dense's gradient: port 9.2e-5, JAX 1.4e-4
MNV2_STATS_ATOL = 1e-4          # running statistics, one fit step: 1.3e-5
MNV2_SGD_ATOL = 5e-3            # parameters after one SGD step: 2.1e-3


def _grad_rel(got, want, names=None):
    names = list(want) if names is None else names
    num = sum(float(((np.asarray(got[k], np.float64)
                      - np.asarray(want[k], np.float64)) ** 2).sum())
              for k in names)
    den = sum(float((np.asarray(want[k], np.float64) ** 2).sum())
              for k in names)
    return (num / den) ** 0.5


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_mobilenet_v2_fit_matches_jax(jx, optimizer):
    """mobilenet-v2's training step against JAX's, from the same weights
    and 8 rows at 32 px (dropout at rate 0 in both). ``FIT_LIMITS`` do
    not hold here, in either package: as for ResNet-50
    (dev/diagnose_resnet50_step.py), a randomly initialised network of
    many batch norms over few values a channel (8 to 32 here) amplifies
    fp32 rounding in its gradient, so
    the port's fp32 gradient is 0.0162 of its norm from the same step in
    float64 and JAX's 0.0186 (the two fp32 steps 0.0257 apart). The
    port's float64 step is the yardstick:

    - each package's fp32 loss (the port's through the estimator's own
      ``_loss_and_grads``) within ``MNV2_LOSS_RTOL`` of the float64 loss;
    - JAX's fp32 gradient within ``MNV2_OVER_PORT`` times the port's own
      fp32 distance from float64, and both packages' Dense gradients
      (which the norms do not amplify) within ``MNV2_HEAD_RTOL``;
    - one ``fit`` step (batch 8) in both packages: the loss within
      ``MNV2_LOSS_RTOL``, the running statistics within
      ``MNV2_STATS_ATOL``, the parameters within ``MNV2_SGD_ATOL`` after
      SGD and, after Adam, within FIT_LIMITS' 2 lr a step (Adam divides
      by the gradient's own magnitude, so a leaf whose gradient is
      rounding noise in both moves by about lr either way)."""
    import copy
    jax = jx["jax"]
    kw = dict(class_num=CLASSES, model_name="mobilenet-v2",
              image_size=SIZE)
    jclf = jx["IC"](**kw)
    params, state = _variables(jx, jclf, optimizer)
    clf = _port_like(params, state, **kw)
    for layer in _graph_layers(jclf.model) + _graph_layers(clf.model):
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0
    x, y = _data(BATCH)
    # JAX's fp32 loss and gradient of the train forward
    fm = jclf.model.to_flax()

    def loss_fn(p):
        out, _ = fm.apply({"params": p, **state}, x, train=True,
                          mutable=["batch_stats"])
        return -jax.numpy.mean(jax.numpy.log(out)[np.arange(BATCH), y])
    jloss, jgrad = jax.value_and_grad(loss_fn)(params)
    jgrad = flatten(jax.device_get(jgrad))
    # the port's, fp32 through the estimator and float64 on a copy
    mod = clf.model.module
    layout = ParamLayout(mod)
    f64 = copy.deepcopy(mod).double()
    clf.compile(optimizer=optimizer, loss=LOSS, device="cpu")
    est = clf.model._ensure_estimator(for_training=True)
    loss32, g32 = est._loss_and_grads(x, y)
    g32 = flatten(state_dict_to_flax(dict(zip(est._names, g32)),
                                     layout.like))
    out64 = f64(torch.from_numpy(x).double(), train=True)
    loss64 = -torch.log(out64)[torch.arange(BATCH),
                               torch.from_numpy(y).long()].mean()
    names64 = [n for n, _ in f64.named_parameters()]
    g64 = torch.autograd.grad(loss64, list(f64.parameters()))
    g64 = flatten(state_dict_to_flax(dict(zip(names64, g64)), layout.like))
    loss64 = float(loss64)
    head = [k for k in g64 if k.startswith("dense_")]
    assert abs(float(loss32) - loss64) <= MNV2_LOSS_RTOL * loss64
    assert abs(float(jloss) - loss64) <= MNV2_LOSS_RTOL * loss64
    assert _grad_rel(jgrad, g64) <= MNV2_OVER_PORT * _grad_rel(g32, g64)
    assert _grad_rel(g32, g64, head) <= MNV2_HEAD_RTOL
    assert _grad_rel(jgrad, g64, head) <= MNV2_HEAD_RTOL
    # one fit step in each package from the same weights
    clf = _port_like(params, state, **kw)
    for layer in _graph_layers(clf.model):
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0
    clf.compile(optimizer=optimizer, loss=LOSS, device="cpu")
    want = jclf.fit(x, y, batch_size=BATCH, nb_epoch=1)
    got = clf.fit(x, y, batch_size=BATCH, nb_epoch=1)
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=MNV2_LOSS_RTOL)
    jstate = jclf.model._estimator._state
    tree = clf.model.estimator._state_tree()
    got_s = flatten(tree["model_state"])
    want_s = flatten(jax.device_get(jstate["model_state"]))
    assert sorted(got_s) == sorted(want_s)
    for k, v in want_s.items():
        np.testing.assert_allclose(np.asarray(got_s[k]), v, rtol=0,
                                   atol=MNV2_STATS_ATOL, err_msg=k)
    # Adam: 2 lr, and the ulps of fp32 parameters near 1 (norm scales)
    p_atol = MNV2_SGD_ATOL if optimizer == "sgd" else 2 * LR + 1e-6
    got_p = flatten(tree["params"])
    for k, v in flatten(jax.device_get(jstate["params"])).items():
        np.testing.assert_allclose(got_p[k], v, rtol=0, atol=p_atol,
                                   err_msg=k)


def test_mobilenet_v2_parameter_count_is_jax(jx):
    jax = jx["jax"]
    jclf = jx["IC"](class_num=5, model_name="mobilenet-v2", image_size=64)
    est = jclf.model._ensure_estimator()
    want = sum(int(np.prod(np.shape(p)))
               for p in jax.tree_util.tree_leaves(est.adapter.params))
    clf = ImageClassifier(class_num=5, model_name="mobilenet-v2",
                          image_size=64)
    n = sum(p.numel() for p in clf.model.module.parameters())
    assert n == want and 2_100_000 < n < 2_500_000, (n, want)


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
                                  "densenet-121", "densenet-161",
                                  "mobilenet", "inception-v1",
                                  "mobilenet-v2"])
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
    """The three architectures that once waited for ROADMAP A11 build
    from the layers they needed: mobilenet's five SeparableConv2D (a
    depthwise and a pointwise convolution each), inception-v1's two LRN2D
    and mobilenet-v2's seventeen depthwise convolutions (a grouped Conv,
    one group a channel, in a KerasLayerWrapper)."""
    from analytics_zoo_tpu_torch.common.flax_compat import Conv
    from analytics_zoo_tpu_torch.keras import layers as zl
    clf = ImageClassifier(class_num=2, model_name=name, image_size=SIZE)
    mod = clf.model.module
    layers = {id(n.layer): n.layer for n in _nodes(clf)}
    if layer == "SeparableConv2D":
        seps = [x for x in layers.values()
                if isinstance(x, zl.SeparableConv2D)]
        assert len(seps) == 5
        for sep in seps:
            sub = getattr(mod, sep.name)
            assert sub.depthwise.groups == sub.depthwise.in_features
            assert sub.pointwise.kernel_size == (1, 1)
    elif layer == "LRN2D":
        assert sum(isinstance(x, zl.LRN2D) for x in layers.values()) == 2
    else:
        dw = [m for m in mod.modules()
              if isinstance(m, Conv) and m.groups > 1]
        assert len(dw) == 17
        assert all(m.groups == m.in_features == m.out_features
                   and m.flax_kernel_shape[2] == 1 for m in dw)
    out = clf.predict(_data(2)[0], batch_size=2, device="cpu")
    assert out.shape == (2, 2) and np.isfinite(out).all()


def _nodes(clf):
    from analytics_zoo_tpu_torch.keras.engine import topo_sort
    return [n for n in topo_sort(clf.model._graph()[1])
            if n.layer is not None]


def test_unknown_name_pretrained_and_image_sets_are_refused():
    """An unknown name and ``pretrained=`` for an architecture with no
    torchvision mapping are refused; ``predict_image_set`` predicts the
    set's images as ``predict`` does."""
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    with pytest.raises(ValueError, match="unknown model_name"):
        ImageClassifier(class_num=2, model_name="resnet-18")
    with pytest.raises(ValueError, match="no pretrained import mapping"):
        ImageClassifier(class_num=2, model_name="resnet-lite",
                        pretrained={})
    clf = ImageClassifier(class_num=2, model_name="lenet", image_size=28)
    x, _ = _data(5, size=28)
    iset = ImageSet.from_arrays(list(x), num_shards=2)
    np.testing.assert_array_equal(
        clf.predict_image_set(iset, batch_size=4, device="cpu"),
        clf.predict(x, batch_size=4, device="cpu"))


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
