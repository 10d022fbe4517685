"""The port's ``SeparableConv2D``, ``LRN2D`` and a grouped
``KerasLayerWrapper(Conv)`` against the JAX package's layers, on the CPU.

Each case builds the same keras layer in both packages (explicit name
``c``), runs JAX's through its own ``make_module``/``apply`` inside a
flax wrapper, copies its parameters into the port's modules through
``convert.flax_to_state_dict`` (the separable layer's nested
``depthwise`` / ``pointwise`` tree, the grouped kernel ``[*k, in /
groups, out]``), and feeds both the same numpy input. Held:

- fp32: the output, the input's gradient and every parameter's gradient
  (``jax.vjp`` against torch's autograd, one cotangent from a seed)
  within ``1e-5`` of the largest magnitude of what is compared
  (measured: at most 3.6e-7 relative); the output shape equal to the
  port layer's inferred shape;
- ``mixed_bfloat16``: the separable layer (both packages compute in
  bf16 from fp32 parameters) bitwise, as the plain convolutions read on
  the CPU (tests/test_torch_conv_layers.py); the wrapped grouped conv,
  which has no dtype of its own in either package and so computes in
  the promoted fp32, at the fp32 limit; ``LRN2D`` on a bf16 input (its power in bf16 in both) within 2
  bf16 ulps of the output's largest value;
- JAX's own goldens (tests/test_keras_layers_golden.py): the separable
  layer against the same depthwise-then-pointwise composition in
  ``torch.nn.functional``, and ``LRN2D`` against
  ``torch.nn.LocalResponseNorm``, at JAX's tolerances.

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common import flax_compat
from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.keras import policy as tpolicy

REL = 1e-5
BF16_ULPS = 2


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
    import flax.linen as fnn
    from analytics_zoo_tpu.keras import layers as jl
    from analytics_zoo_tpu.keras import policy as jpolicy
    return dict(jax=jax, nn=fnn, jl=jl, policy=jpolicy)


def _wrapper(jx, layer):
    fnn = jx["nn"]

    class W(fnn.Module):
        @fnn.compact
        def __call__(self, a):
            return layer.apply(layer.make_module(), [a], False)
    return W()


def _layers(jx, kind, args, kwargs, dtype="float32"):
    """The same layer in both packages, built under ``dtype``'s policy.
    ``kind`` "grouped" is a KerasLayerWrapper around a grouped conv:
    ``args`` (in, out, kernel, strides, padding)."""
    with jx["policy"].policy_scope(dtype), tpolicy.policy_scope(dtype):
        if kind != "grouped":
            return (getattr(jx["jl"], kind)(*args, name="c", **kwargs),
                    getattr(tl, kind)(*args, name="c", **kwargs))
        cin, cout, k, s, pad = args
        groups = kwargs["groups"]
        jconv = jx["nn"].Conv(features=cout, kernel_size=k, strides=s,
                              padding=pad, feature_group_count=groups,
                              use_bias=kwargs.get("bias", False))
        tconv = flax_compat.Conv(cin, cout, k, bias=kwargs.get("bias", False),
                                 strides=s, padding=pad,
                                 feature_group_count=groups)
        return (jx["jl"].KerasLayerWrapper(jconv, name="c"),
                tl.KerasLayerWrapper(tconv, name="c"))


def _port(layer, shape, params):
    mods = torch.nn.ModuleDict(layer.make_modules(
        [tuple(shape)], torch.Generator().manual_seed(0)))
    mods.load_state_dict(flax_to_state_dict(params), strict=True)
    return mods


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= REL * scale, f"{what}: {err} of {scale}"


def _check_fp32(jx, kind, args, kwargs, shape, seed=0):
    jax = jx["jax"]
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    jlayer, tlayer = _layers(jx, kind, args, kwargs)
    w = _wrapper(jx, jlayer)
    params = jax.device_get(w.init(jax.random.PRNGKey(0), x))
    params = params.get("params", {})
    want, vjp = jax.vjp(lambda p, a: w.apply({"params": p}, a), params, x)
    want = np.asarray(want)
    cot = rng.randn(*want.shape).astype(np.float32)
    gp_want, gx_want = jax.device_get(vjp(cot))

    mods = _port(tlayer, shape[1:], params)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tlayer.apply(dict(mods.items()), [xt], False)
    assert tuple(got.shape) == want.shape
    assert tuple(got.shape[1:]) == tuple(tlayer._infer_shape([shape[1:]]))
    got.backward(torch.from_numpy(cot))
    _close(got.detach().numpy(), want, "output")
    _close(xt.grad.numpy(), gx_want, "input gradient")
    if params:
        grads = {n: p.grad for n, p in mods.named_parameters()}
        gp = state_dict_to_flax(grads, params)
        for path, leaf in _leaves(gp_want):
            _close(_at(gp, path), leaf, f"gradient {'/'.join(path)}")


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _run_bf16(jx, kind, args, kwargs, shape, seed=0):
    jax = jx["jax"]
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jlayer, tlayer = _layers(jx, kind, args, kwargs, "mixed_bfloat16")
    w = _wrapper(jx, jlayer)
    params = jax.device_get(w.init(jax.random.PRNGKey(0), x))
    want = w.apply(params, x)
    mods = _port(tlayer, shape[1:], params.get("params", {}))
    got = tlayer.apply(dict(mods.items()), [torch.from_numpy(x)], False)
    return (np.asarray(want.astype("float32")), str(want.dtype),
            got.detach().float().numpy(), got.dtype)


SEPARABLE = [
    # nb_filter, rows, cols; kwargs; input shape
    ((5, 3, 3), {}, (2, 9, 10, 3)),
    ((5, 3, 3), {"depth_multiplier": 2}, (2, 9, 10, 3)),
    ((5, 3, 3), {"border_mode": "same"}, (2, 9, 10, 3)),
    ((5, 3, 3), {"border_mode": "same", "subsample": (2, 2)},
     (2, 9, 10, 3)),
    ((4, 3, 3), {"border_mode": "same", "subsample": (2, 2),
                 "depth_multiplier": 2, "activation": "relu"},
     (2, 8, 8, 4)),
    ((6, 3, 3), {"subsample": (2, 2), "depth_multiplier": 2},
     (2, 11, 9, 3)),
]

GROUPED = [
    # (in, out, kernel, strides, padding), kwargs, input shape
    ((6, 6, (3, 3), (1, 1), ((1, 1), (1, 1))), {"groups": 6},
     (2, 8, 8, 6)),
    ((6, 6, (3, 3), (2, 2), ((1, 1), (1, 1))), {"groups": 6},
     (2, 9, 9, 6)),
    ((4, 8, (3, 3), (2, 2), "SAME"), {"groups": 4, "bias": True},
     (2, 8, 8, 4)),
    ((6, 4, (3, 3), (1, 1), "VALID"), {"groups": 2}, (2, 7, 7, 6)),
]

LRN = [({}, (2, 5, 5, 7)),
       ({"alpha": 1e-2, "k": 1.2, "beta": 0.6, "n": 3}, (2, 5, 5, 7)),
       ({"alpha": 1e-1, "n": 4}, (2, 4, 6, 9))]


@pytest.mark.parametrize("args,kwargs,shape", SEPARABLE)
def test_separable_conv2d_matches_jax(jx, args, kwargs, shape):
    _check_fp32(jx, "SeparableConv2D", args, kwargs, shape)


@pytest.mark.parametrize("args,kwargs,shape", GROUPED)
def test_grouped_wrapper_matches_jax(jx, args, kwargs, shape):
    _check_fp32(jx, "grouped", args, kwargs, shape)


@pytest.mark.parametrize("kwargs,shape", LRN)
def test_lrn2d_matches_jax(jx, kwargs, shape):
    _check_fp32(jx, "LRN2D", (), kwargs, shape)


@pytest.mark.parametrize("kind,args,kwargs,shape", [
    ("SeparableConv2D",) + SEPARABLE[1], ("SeparableConv2D",) + SEPARABLE[4],
    ("grouped",) + GROUPED[1], ("grouped",) + GROUPED[2]])
def test_bf16_convolutions_match_jax(jx, kind, args, kwargs, shape):
    want, wdt, got, gdt = _run_bf16(jx, kind, args, kwargs, shape)
    # the separable layer computes in bf16, bitwise; the wrapped conv has
    # no dtype of its own and computes in the promoted fp32, as flax's
    # does, held as fp32 is
    if kind == "SeparableConv2D":
        assert (wdt, gdt) == ("bfloat16", torch.bfloat16)
        np.testing.assert_array_equal(got, want)
    else:
        assert (wdt, gdt) == ("float32", torch.float32)
        _close(got, want, "output")


def test_bf16_lrn2d_within_two_ulps(jx):
    """``LRN2D`` on a bf16 input (the output of a bf16 convolution)."""
    jax = jx["jax"]
    x = np.abs(np.random.RandomState(4).randn(2, 5, 5, 7)) + 0.1
    xb = jax.numpy.asarray(x, jax.numpy.bfloat16)
    jlayer, tlayer = _layers(jx, "LRN2D", (), {"alpha": 1e-2, "n": 3})
    want = np.asarray(_wrapper(jx, jlayer).apply({}, xb).astype("float32"))
    got = tlayer.apply({}, [torch.from_numpy(x).to(torch.bfloat16)], False)
    assert got.dtype == torch.bfloat16
    limit = BF16_ULPS * 2.0 ** -8 * float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= limit


def test_separable_tree_is_nested_as_flax(jx):
    jax = jx["jax"]
    x = np.zeros((1, 6, 6, 3), np.float32)
    jlayer, tlayer = _layers(jx, "SeparableConv2D", (5, 3, 3),
                             {"depth_multiplier": 2})
    params = jax.device_get(_wrapper(jx, jlayer).init(
        jax.random.PRNGKey(0), x))["params"]
    shapes = {"/".join(p): np.shape(v) for p, v in _leaves(params)}
    assert shapes == {"c/depthwise/kernel": (3, 3, 1, 6),
                      "c/depthwise/bias": (6,),
                      "c/pointwise/kernel": (1, 1, 6, 5),
                      "c/pointwise/bias": (5,)}
    from analytics_zoo_tpu_torch.convert import flatten, flax_layout
    mods = torch.nn.ModuleDict(tlayer.make_modules(
        [(6, 6, 3)], torch.Generator().manual_seed(0)))
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in flatten(flax_layout(mods)).items()}
    assert got == shapes


# ---- JAX's goldens (tests/test_keras_layers_golden.py), on the port ----

def test_separable_conv2d_golden_against_torch():
    x = np.random.RandomState(0).randn(2, 9, 10, 3).astype(np.float32)
    layer = tl.SeparableConvolution2D(5, 3, 3, depth_multiplier=2,
                                      name="sep")
    mods = layer.make_modules([(9, 10, 3)], torch.Generator().manual_seed(1))
    got = layer.apply(mods, [torch.from_numpy(x)], False).detach().numpy()
    sep = mods["sep"]
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2))
    mid = F.conv2d(tx, sep.depthwise.torch_weight(torch.float32),
                   sep.depthwise.bias, groups=3)
    want = F.conv2d(mid, sep.pointwise.torch_weight(torch.float32),
                    sep.pointwise.bias).detach().numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1),
                               rtol=1e-4, atol=1e-4)


def test_lrn2d_golden_against_torch():
    x = np.abs(np.random.RandomState(0).randn(2, 5, 5, 7)).astype(
        np.float32) + 0.1
    got = tl.LRN2D(alpha=1e-2, k=1.2, beta=0.6, n=3).apply(
        {}, [torch.from_numpy(x)], False).numpy()
    lrn = torch.nn.LocalResponseNorm(3, alpha=1e-2, beta=0.6, k=1.2)
    want = lrn(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1),
                               rtol=1e-4, atol=1e-5)


def test_grouped_conv_refuses_groups_that_do_not_divide():
    with pytest.raises(ValueError, match="feature_group_count"):
        flax_compat.Conv(6, 4, (3, 3), feature_group_count=4)


def test_wrapper_copies_its_module_per_model():
    """Two models built from one wrapper hold their own weights, drawn
    from each graph's generator."""
    from analytics_zoo_tpu_torch.keras import Input, Model
    layer = tl.KerasLayerWrapper(flax_compat.Conv(
        4, 4, (3, 3), bias=False, feature_group_count=4))
    inp = Input(shape=(6, 6, 4))
    m = Model(input=inp, output=layer(inp))
    w1 = m.module.keraslayerwrapper_1.weight
    assert w1 is not layer.module.weight
    assert tuple(w1.shape) == (4, 9)
    m2 = Model(input=inp, output=layer(inp))
    assert torch.equal(m2.module.keraslayerwrapper_1.weight, w1)
