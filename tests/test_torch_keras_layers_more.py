"""The rest of the keras layer library in the port against the JAX
package's, on the CPU, family by family as JAX's
tests/test_keras_layers_golden.py takes them.

Each case builds ``Input -> layer -> Model`` in both packages (the same
canonical layer names), initialises JAX's, carries its parameters into
the port's module through ``convert.flax_to_state_dict`` and feeds both
the same numpy input. Held: fp32 outputs within 1e-5 absolute (JAX's
tests hold most layers to 1e-5 or 1e-6 of a numpy reference; measured
here: 0 for the shape, crop, upsampling and parameter layers and all
but four elementwise ones (2.4e-7 at most), at most 4.8e-7 for the
convolutions, the locally connected layers, ConvLSTM (its input
gradient 2.1e-7) and the dense variants, 1.4e-6 for the bilinear resize
with aligned corners, 1.2e-7 without) and the output shape
equal to the port layer's inferred shape where it infers one. The
parameter trees (names and shapes) equal JAX's. The randomized layers
draw from another generator than JAX's, so in eval mode they equal JAX's
output and in training their statistics are held: RReLU's slopes in
[lower, upper], the noise layers' mean and spread, spatial dropout's
whole-channel masks. JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (flatten, flax_layout,
                                             flax_to_state_dict,
                                             state_dict_to_flax)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from analytics_zoo_tpu.keras import Input, Model
    from analytics_zoo_tpu.keras import layers as jl
    return dict(jax=jax, jl=jl, Input=Input, Model=Model)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def run_both(jx, make, *xs, train=False, seed=0):
    """``make(layers_module)`` builds the layer; returns (port output,
    JAX output, port model, JAX params)."""
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as tl
    jax = jx["jax"]
    jin = [jx["Input"](shape=x.shape[1:]) for x in xs]
    jout = make(jx["jl"])(jin if len(jin) > 1 else jin[0])
    jm = jx["Model"](input=jin if len(jin) > 1 else jin[0], output=jout)
    module = jm.to_flax()
    rngs = {"params": jax.random.PRNGKey(seed),
            "dropout": jax.random.PRNGKey(seed + 1)}
    variables = module.init(rngs, *xs, train=train)
    want = module.apply(variables, *xs, train=train,
                        rngs={"dropout": jax.random.PRNGKey(seed + 2)})
    params = jax.device_get(variables.get("params", {}))
    tin = [Input(shape=x.shape[1:]) for x in xs]
    layer = make(tl)
    tout = layer(tin if len(tin) > 1 else tin[0])
    tm = Model(input=tin if len(tin) > 1 else tin[0], output=tout)
    tm.module.load_state_dict(flax_to_state_dict(params), strict=True)
    tm.module.train(train)
    with torch.no_grad():
        got = tm.module(*[torch.tensor(x) for x in xs], train=train)
    if tout.shape is not None:
        assert tuple(got.shape[1:]) == tuple(tout.shape)
    return got.numpy(), np.asarray(want), tm, params


def _same_tree(tm, params):
    like = flax_layout(tm.module)
    assert {k: tuple(v.shape) for k, v in flatten(like).items()} == \
        {k: tuple(np.shape(v)) for k, v in flatten(params).items()}
    back = state_dict_to_flax(tm.module.state_dict(), params)
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(flatten(back)[k], np.asarray(v))


# ---------------------------------------------------------- elementwise

ELEMENTWISE = {
    "Identity": lambda L: L.Identity(),
    "Exp": lambda L: L.Exp(),
    "Log": lambda L: L.Log(),
    "Sqrt": lambda L: L.Sqrt(),
    "Square": lambda L: L.Square(),
    "Negative": lambda L: L.Negative(),
    "AddConstant": lambda L: L.AddConstant(2.5),
    "MulConstant": lambda L: L.MulConstant(-3.0),
    "Power": lambda L: L.Power(2.0, scale=2.0, shift=1.0),
    "HardTanh": lambda L: L.HardTanh(-0.5, 0.5),
    "HardShrink": lambda L: L.HardShrink(0.5),
    "SoftShrink": lambda L: L.SoftShrink(0.5),
    "Threshold": lambda L: L.Threshold(0.2, -7.0),
    "BinaryThreshold": lambda L: L.BinaryThreshold(0.0),
    "LeakyReLU": lambda L: L.LeakyReLU(0.1),
    "ELU": lambda L: L.ELU(1.5),
    "ThresholdedReLU": lambda L: L.ThresholdedReLU(0.7),
    "RReLU_eval": lambda L: L.RReLU(0.1, 0.3),
    "GaussianNoise_eval": lambda L: L.GaussianNoise(0.5),
    "GaussianDropout_eval": lambda L: L.GaussianDropout(0.5),
    "SpatialDropout1D_eval": lambda L: L.SpatialDropout1D(0.5),
}


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_matches_jax(jx, name):
    x = _x((4, 5, 6))
    if name in ("Log", "Sqrt"):
        x = np.abs(x) + 1.0
    got, want, _, params = run_both(jx, ELEMENTWISE[name], x)
    assert params == {}
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


# ----------------------------------------------------------- shape layers

SHAPE = {
    "Reshape": (lambda L: L.Reshape((6, 5)), (3, 5, 6)),
    "Reshape_infer": (lambda L: L.Reshape((-1, 3)), (3, 5, 6)),
    "Permute": (lambda L: L.Permute((2, 1)), (3, 5, 6)),
    "RepeatVector": (lambda L: L.RepeatVector(4), (3, 6)),
    "Squeeze": (lambda L: L.Squeeze(2), (3, 5, 1, 6)),
    "ExpandDim": (lambda L: L.ExpandDim(1), (3, 5, 6)),
    "Select": (lambda L: L.Select(1, 2), (3, 5, 6)),
    "Select_last": (lambda L: L.Select(-1, 0), (3, 5, 6)),
    "Max": (lambda L: L.Max(dim=1), (3, 5, 4)),
    "Masking": (lambda L: L.Masking(0.0), (3, 5, 4)),
    "Cropping1D": (lambda L: L.Cropping1D((2, 3)), (2, 10, 3)),
    "Cropping2D": (lambda L: L.Cropping2D(((1, 2), (3, 0))), (2, 8, 9, 3)),
    "Cropping3D": (lambda L: L.Cropping3D(((1, 1), (0, 2), (1, 0))),
                   (2, 4, 5, 6, 3)),
    "UpSampling1D": (lambda L: L.UpSampling1D(3), (2, 4, 3)),
    "UpSampling2D": (lambda L: L.UpSampling2D((2, 3)), (2, 4, 5, 3)),
    "UpSampling3D": (lambda L: L.UpSampling3D((2, 1, 2)), (2, 4, 5, 6, 3)),
    "ResizeBilinear_up": (lambda L: L.ResizeBilinear(10, 14), (2, 5, 7, 3)),
    "ResizeBilinear_down": (lambda L: L.ResizeBilinear(4, 3),
                            (2, 9, 7, 3)),
    "ResizeBilinear_up_corners": (
        lambda L: L.ResizeBilinear(10, 14, align_corners=True),
        (2, 5, 7, 3)),
    "ResizeBilinear_down_corners": (
        lambda L: L.ResizeBilinear(4, 3, align_corners=True), (2, 9, 7, 3)),
    "WithinChannelLRN2D": (
        lambda L: L.WithinChannelLRN2D(size=3, alpha=0.1, beta=0.75),
        (2, 6, 7, 3)),
}


@pytest.mark.parametrize("name", sorted(SHAPE))
def test_shape_layers_match_jax(jx, name):
    make, shape = SHAPE[name]
    x = _x(shape)
    if name == "Masking":
        x[:, 1] = 0.0
        x[0, 3] = 0.0
    got, want, _, _ = run_both(jx, make, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_multi_input_and_constant_layers_match_jax(jx):
    a, b = _x((3, 4), 1), _x((3, 4), 2)
    got, want, _, _ = run_both(jx, lambda L: L.SelectTable(1), a, b)
    np.testing.assert_array_equal(got, want)
    # eval-mode GaussianSampler returns the mean
    got, want, _, _ = run_both(jx, lambda L: L.GaussianSampler(), a, b)
    np.testing.assert_array_equal(got, want)
    from analytics_zoo_tpu_torch.keras import layers as tl
    from analytics_zoo_tpu.keras import layers as jl
    x = torch.zeros(3, 5, 2)
    np.testing.assert_array_equal(
        tl.GetShape().apply({}, [x], False).numpy(),
        np.asarray(jl.GetShape().apply(None, [np.zeros((3, 5, 2))], False)))
    for value in (2.5, [1, 2, 3], np.eye(2)):
        got = tl.Constant(value).apply({}, [x], False)
        want = np.asarray(jl.Constant(value).apply(None, [], False))
        assert str(got.numpy().dtype) == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------- parameter layers

PARAMS = {
    "CAdd": (lambda L: L.CAdd((5, 6), name="p"), (3, 5, 6)),
    "CAdd_broadcast": (lambda L: L.CAdd((1, 6), name="p"), (3, 5, 6)),
    "CMul": (lambda L: L.CMul((6,), name="p"), (3, 5, 6)),
    "Scale": (lambda L: L.Scale((5, 6), name="p"), (3, 5, 6)),
    "Mul": (lambda L: L.Mul(name="p"), (3, 5, 6)),
    "PReLU": (lambda L: L.PReLU(name="p"), (3, 5, 6)),
    "SReLU": (lambda L: L.SReLU(name="p"), (3, 5, 6)),
}


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_param_layers_match_jax(jx, name):
    """The parameters are set away from their inits in JAX's tree (a
    random draw), carried into the port and back unchanged."""
    make, shape = PARAMS[name]
    x = _x(shape)
    _, _, tm, params = run_both(jx, make, x)
    rng = np.random.RandomState(3)
    params = {k: {n: rng.uniform(-1, 1, np.shape(v)).astype(np.float32)
                  for n, v in sub.items()} for k, sub in params.items()}
    tm.module.load_state_dict(flax_to_state_dict(params), strict=True)
    _same_tree(tm, params)
    jin = jx["Input"](shape=shape[1:])
    jm = jx["Model"](input=jin, output=make(jx["jl"])(jin))
    want = np.asarray(jm.to_flax().apply({"params": params}, x))
    with torch.no_grad():
        got = tm.module(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ------------------------------------------------------- randomized layers

def _train_out(make, x):
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as tl
    ins = [Input(shape=a.shape[1:]) for a in x]
    out = make(tl)(ins if len(ins) > 1 else ins[0])
    m = Model(input=ins if len(ins) > 1 else ins[0], output=out)
    torch.manual_seed(0)
    return m.module(*[torch.tensor(a) for a in x], train=True).numpy()


def test_randomized_layers_in_training():
    """JAX tests/test_keras_layers_golden.py's statistics, on the port's
    draws."""
    x = _x((4, 6))
    got = _train_out(lambda L: L.RReLU(0.1, 0.3), [x])
    neg = x < 0
    slopes = got[neg] / x[neg]
    assert (slopes >= 0.1 - 1e-6).all() and (slopes <= 0.3 + 1e-6).all()
    assert slopes.std() > 0.01
    ones = np.ones((64, 64), np.float32)
    noise = _train_out(lambda L: L.GaussianNoise(0.5), [ones]) - ones
    assert 0.4 < noise.std() < 0.6 and abs(noise.mean()) < 0.05
    gd = _train_out(lambda L: L.GaussianDropout(0.5), [ones])
    assert abs(gd.mean() - 1.0) < 0.05 and 0.9 < gd.std() < 1.1
    for make, shape in ((lambda L: L.SpatialDropout1D(0.5), (8, 16, 32)),
                        (lambda L: L.SpatialDropout2D(0.5), (4, 5, 6, 8)),
                        (lambda L: L.SpatialDropout3D(0.5),
                         (2, 3, 4, 5, 6))):
        out = _train_out(make, [np.ones(shape, np.float32)])
        flat = out.reshape(shape[0], -1, shape[-1])
        per_map = (flat == 0).all(axis=1) | np.isclose(flat, 2.0).all(axis=1)
        assert per_map.all()
        assert (flat == 0).any() and np.isclose(flat, 2.0).any()
    mean = np.full((2048, 4), 3.0, np.float32)
    logv = np.full((2048, 4), np.log(0.25), np.float32)
    s = _train_out(lambda L: L.GaussianSampler(), [mean, logv])
    assert abs(s.mean() - 3.0) < 0.05 and abs(s.std() - 0.5) < 0.05


# ------------------------------------------------------------ convolutions

CONVS = {
    "AtrousConvolution1D": (
        lambda L: L.AtrousConvolution1D(4, 3, atrous_rate=2,
                                        activation="relu"), (2, 12, 3)),
    "AtrousConvolution2D": (
        lambda L: L.AtrousConvolution2D(4, 3, 3, atrous_rate=(2, 3),
                                        border_mode="same"), (2, 9, 10, 3)),
    "AtrousConvolution2D_pad": (
        lambda L: L.AtrousConvolution2D(4, 3, 3, atrous_rate=(6, 6),
                                        border_mode=6), (2, 13, 13, 3)),
    "Deconvolution2D_valid": (
        lambda L: L.Deconvolution2D(4, 3, 3), (2, 5, 6, 3)),
    "Deconvolution2D_valid_s2": (
        lambda L: L.Deconvolution2D(4, 3, 3, subsample=(2, 2)),
        (2, 5, 6, 3)),
    "Deconvolution2D_same_s2": (
        lambda L: L.Deconvolution2D(4, 3, 3, border_mode="same",
                                    subsample=(2, 2), activation="tanh"),
        (2, 5, 6, 3)),
    "Deconvolution2D_same_k2s2": (
        lambda L: L.Deconvolution2D(4, 2, 2, border_mode="same",
                                    subsample=(2, 2)), (2, 5, 6, 3)),
    "ShareConvolution2D": (
        lambda L: L.ShareConvolution2D(3, 3, 3), (2, 6, 6, 2)),
    "LocallyConnected1D": (
        lambda L: L.LocallyConnected1D(4, 3, subsample_length=2),
        (2, 11, 3)),
    "LocallyConnected1D_nobias": (
        lambda L: L.LocallyConnected1D(4, 3, bias=False,
                                       activation="relu"), (2, 9, 3)),
    "LocallyConnected2D": (
        lambda L: L.LocallyConnected2D(4, 3, 2, subsample=(2, 1)),
        (2, 7, 6, 3)),
    "LocallyConnected2D_nobias": (
        lambda L: L.LocallyConnected2D(4, 2, 2, bias=False), (2, 5, 5, 2)),
    "ConvLSTM2D_sequences": (
        lambda L: L.ConvLSTM2D(5, 3, return_sequences=True),
        (2, 4, 6, 6, 3)),
    "ConvLSTM2D_last": (lambda L: L.ConvLSTM2D(5, 3), (2, 4, 6, 6, 3)),
    "ConvLSTM2D_backwards": (
        lambda L: L.ConvLSTM2D(5, 3, return_sequences=True,
                               go_backwards=True), (2, 3, 5, 5, 2)),
    "ConvLSTM3D": (lambda L: L.ConvLSTM3D(3, 3, return_sequences=True),
                   (1, 3, 4, 4, 4, 2)),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_convolution_layers_match_jax(jx, name):
    make, shape = CONVS[name]
    got, want, tm, params = run_both(jx, make, _x(shape))
    assert got.shape == want.shape
    _same_tree(tm, params)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_convlstm_gradients_match_jax(jx):
    """One backward through ConvLSTM2D's steps: the input's gradient."""
    jax = jx["jax"]
    x = _x((2, 3, 5, 5, 2))
    _, _, tm, params = run_both(
        jx, lambda L: L.ConvLSTM2D(3, 3, return_sequences=True), x)
    jin = jx["Input"](shape=x.shape[1:])
    jm = jx["Model"](input=jin, output=jx["jl"].ConvLSTM2D(
        3, 3, return_sequences=True)(jin))
    fm = jm.to_flax()
    want = np.asarray(jax.grad(lambda a: fm.apply(
        {"params": params}, a).sum())(x))
    xt = torch.tensor(x, requires_grad=True)
    tm.module(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=ATOL)


# ---------------------------------------------------------- dense variants

DENSE = {
    "Highway": lambda L: L.Highway(activation="tanh"),
    "Highway_nobias": lambda L: L.Highway(activation="relu", bias=False),
    "MaxoutDense": lambda L: L.MaxoutDense(3, nb_feature=4),
    "SparseDense": lambda L: L.SparseDense(5),
}


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_variants_match_jax(jx, name):
    got, want, tm, params = run_both(jx, DENSE[name], _x((4, 6)))
    _same_tree(tm, params)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_every_jax_layer_class_is_in_the_port():
    """The port's keras library names every layer class JAX's has."""
    import inspect
    from analytics_zoo_tpu_torch.keras import layers as tl
    from analytics_zoo_tpu.keras import layers as jl
    jax_names = {n for n, c in vars(jl).items() if inspect.isclass(c)
                 and issubclass(c, jl.KerasLayer) and not n.startswith("_")}
    missing = sorted(n for n in jax_names if not hasattr(tl, n))
    assert missing == []
