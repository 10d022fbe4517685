"""The port's convolution, pooling and padding layers against the JAX
package's, on the CPU.

Each case builds the same keras layer in both packages (explicit name
``c``), runs JAX's through its own ``make_module``/``apply`` inside a
flax wrapper, copies its parameters into the port's modules through
``convert.flax_to_state_dict``, and feeds both the same numpy input
(channels-last, as both packages lay it out):

- ``Conv1D`` / ``Conv2D`` / ``Conv3D``: VALID, SAME at strides 1 and 2 on
  odd and even sizes (XLA's SAME puts the odd cell on the high side),
  int, pair and ``((lo, hi), ...)`` padding, dilation, with and without a
  bias;
- the max and average pools, 1-D to 3-D, padded included (a max pool
  pads with -inf, an average pool counts padded zeros);
- the global pools and ``ZeroPadding1D/2D/3D``.

Held: fp32 outputs within 1e-5 absolute (measured: at most 4.8e-7; the
two packages sum a window in another order), the output shape equal to
the port layer's inferred shape, and under ``mixed_bfloat16`` (both
packages compute in bf16 from fp32 parameters) within 2 bf16 ulps of the
output's largest value, ``2 * 2^-8 * max|out|`` (one rounding of each
side's bf16 result, whose fp32 sums differ in order; measured: 0, the
same bits). ``convert``'s round
trip of 4-D and 5-D kernels is exact. JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.keras import policy as tpolicy

FP32_ATOL = 1e-5
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


def run_jax(jx, layer, x, train=False, variables=None):
    """The JAX layer on ``x``: (output, variables after the call)."""
    fnn, jax = jx["nn"], jx["jax"]

    class W(fnn.Module):
        @fnn.compact
        def __call__(self, a, train=False):
            return layer.apply(layer.make_module(), [a], train)

    if variables is None:
        variables = W().init(jax.random.PRNGKey(0), x)
    if train:
        out, mut = W().apply(variables, x, train=True,
                             mutable=["batch_stats"])
        variables = {**variables, **mut}
    else:
        out = W().apply(variables, x)
    return np.asarray(out.astype("float32")), jax.device_get(variables)


def port_modules(layer, shape, variables):
    """The port layer's modules for input ``shape`` (batch excluded),
    holding JAX's variables."""
    mods = torch.nn.ModuleDict(layer.make_modules(
        [tuple(shape)], torch.Generator().manual_seed(0)))
    state = {}
    for coll in ("params", "batch_stats"):
        if coll in variables:
            state.update(flax_to_state_dict(variables[coll]))
    mods.load_state_dict(state, strict=True)
    return mods


def run_port(layer, x, variables, train=False, mods=None):
    if mods is None:
        mods = port_modules(layer, x.shape[1:], variables)
    got = layer.apply(dict(mods.items()), [torch.from_numpy(x)], train)
    return got.detach().float().numpy(), mods


def build(jx, kind, args, kwargs, dtype="float32"):
    """The same layer in both packages, built under ``dtype``'s policy."""
    with jx["policy"].policy_scope(dtype), tpolicy.policy_scope(dtype):
        return (getattr(jx["jl"], kind)(*args, name="c", **kwargs),
                getattr(tl, kind)(*args, name="c", **kwargs))


def check(jx, kind, args, kwargs, shape, dtype="float32", seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jlayer, tlayer = build(jx, kind, args, kwargs, dtype)
    want, variables = run_jax(jx, jlayer, x)
    got, _ = run_port(tlayer, x, variables)
    assert got.shape == want.shape
    assert tuple(got.shape[1:]) == tuple(tlayer._infer_shape([shape[1:]]))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    else:
        limit = BF16_ULPS * 2.0 ** -8 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= limit


CONV_CASES = [
    # kind, args, kwargs, input shape
    ("Conv1D", (6, 3), {}, (2, 11, 4)),
    ("Conv1D", (6, 3), {"border_mode": "same"}, (2, 11, 4)),
    ("Conv1D", (6, 4), {"border_mode": "same", "subsample_length": 2},
     (2, 10, 4)),
    ("Conv1D", (6, 3), {"border_mode": "same", "subsample_length": 2},
     (2, 11, 4)),
    ("Conv1D", (6, 3), {"dilation_rate": 2, "bias": False}, (2, 12, 4)),
    ("Conv2D", (5, 3, 3), {}, (2, 9, 8, 3)),
    ("Conv2D", (5, 3, 3), {"border_mode": "same"}, (2, 9, 8, 3)),
    ("Conv2D", (5, 3, 3), {"border_mode": "same", "subsample": (2, 2)},
     (2, 9, 9, 3)),
    ("Conv2D", (5, 3, 3), {"border_mode": "same", "subsample": (2, 2)},
     (2, 8, 8, 3)),
    ("Conv2D", (5, 1, 1), {"border_mode": "same", "subsample": (2, 2)},
     (2, 8, 9, 3)),
    ("Conv2D", (5, 7, 7), {"border_mode": 3, "subsample": (2, 2),
                           "bias": False}, (2, 16, 16, 3)),
    ("Conv2D", (5, 3, 2), {"border_mode": (1, 2)}, (2, 7, 8, 3)),
    ("Conv2D", (5, 3, 3), {"border_mode": ((0, 1), (2, 0)),
                           "subsample": (2, 1)}, (2, 9, 8, 3)),
    ("Conv3D", (4, 2, 3, 3), {}, (2, 5, 6, 7, 2)),
    ("Conv3D", (4, 3, 3, 3), {"border_mode": "same",
                              "subsample": (2, 2, 1)}, (2, 5, 6, 7, 2)),
    ("Conv3D", (4, 1, 2, 2), {"bias": False}, (2, 4, 4, 4, 2)),
]


@pytest.mark.parametrize("kind,args,kwargs,shape", CONV_CASES)
def test_convolution_matches_jax(jx, kind, args, kwargs, shape):
    check(jx, kind, args, kwargs, shape)


POOL_CASES = [
    ("MaxPooling1D", (), {}, (2, 9, 3)),
    ("MaxPooling1D", (3,), {"stride": 2, "border_mode": "same"}, (2, 10, 3)),
    ("AveragePooling1D", (3,), {"stride": 2, "border_mode": "same"},
     (2, 9, 3)),
    ("AveragePooling1D", (2,), {"border_mode": ((1, 0),)}, (2, 9, 3)),
    ("MaxPooling2D", (), {}, (2, 9, 8, 3)),
    ("MaxPooling2D", ((3, 3),), {"strides": (2, 2), "border_mode": 1},
     (2, 9, 9, 3)),
    ("MaxPooling2D", ((3, 3),), {"strides": (2, 2), "border_mode": "same"},
     (2, 8, 9, 3)),
    ("MaxPooling2D", ((2, 2),), {"border_mode": ((0, 1), (1, 0))},
     (2, 7, 7, 3)),
    ("MaxPooling2D", ((3, 3),), {"strides": (1, 1), "border_mode": 2},
     (2, 6, 6, 3)),
    ("AveragePooling2D", (), {}, (2, 9, 8, 3)),
    ("AveragePooling2D", ((3, 3),), {"strides": (2, 2), "border_mode": 1},
     (2, 9, 9, 3)),
    ("AveragePooling2D", ((3, 3),), {"strides": (2, 2),
                                     "border_mode": "same"}, (2, 8, 9, 3)),
    ("AveragePooling2D", ((2, 2),), {"border_mode": ((0, 1), (1, 0))},
     (2, 7, 7, 3)),
    ("MaxPooling3D", (), {}, (2, 4, 5, 6, 2)),
    ("MaxPooling3D", ((3, 3, 3),), {"strides": (2, 2, 2),
                                    "border_mode": "same"}, (2, 5, 6, 7, 2)),
    ("AveragePooling3D", (), {}, (2, 4, 5, 6, 2)),
    ("AveragePooling3D", ((3, 3, 3),), {"strides": (2, 2, 2),
                                        "border_mode": 1}, (2, 5, 6, 7, 2)),
]


@pytest.mark.parametrize("kind,args,kwargs,shape", POOL_CASES)
def test_pool_matches_jax(jx, kind, args, kwargs, shape):
    check(jx, kind, args, kwargs, shape)


SHAPE_CASES = [
    ("GlobalMaxPooling1D", (), {}, (2, 7, 3)),
    ("GlobalAveragePooling1D", (), {}, (2, 7, 3)),
    ("GlobalMaxPooling2D", (), {}, (2, 5, 6, 3)),
    ("GlobalAveragePooling2D", (), {}, (2, 5, 6, 3)),
    ("GlobalMaxPooling3D", (), {}, (2, 3, 4, 5, 2)),
    ("GlobalAveragePooling3D", (), {}, (2, 3, 4, 5, 2)),
    ("ZeroPadding1D", (), {}, (2, 7, 3)),
    ("ZeroPadding1D", ((2, 1),), {}, (2, 7, 3)),
    ("ZeroPadding2D", (), {}, (2, 5, 6, 3)),
    ("ZeroPadding2D", ((2, 0),), {}, (2, 5, 6, 3)),
    ("ZeroPadding3D", (), {}, (2, 3, 4, 5, 2)),
    ("ZeroPadding3D", ((1, 0, 2),), {}, (2, 3, 4, 5, 2)),
]


@pytest.mark.parametrize("kind,args,kwargs,shape", SHAPE_CASES)
def test_global_pools_and_padding_match_jax(jx, kind, args, kwargs, shape):
    check(jx, kind, args, kwargs, shape)


BF16_CASES = [
    ("Conv1D", (6, 3), {"border_mode": "same", "subsample_length": 2},
     (2, 11, 4)),
    ("Conv2D", (8, 3, 3), {"border_mode": "same", "subsample": (2, 2)},
     (2, 9, 9, 5)),
    ("Conv2D", (8, 3, 3), {"border_mode": 1, "bias": False}, (2, 8, 8, 5)),
    ("Conv3D", (4, 3, 3, 3), {"border_mode": "same"}, (2, 5, 6, 7, 2)),
]


@pytest.mark.parametrize("kind,args,kwargs,shape", BF16_CASES)
def test_convolution_under_mixed_bfloat16(jx, kind, args, kwargs, shape):
    check(jx, kind, args, kwargs, shape, dtype="mixed_bfloat16")


def test_mixed_bfloat16_keeps_fp32_parameters_and_computes_in_bf16():
    with tpolicy.policy_scope("mixed_bfloat16"):
        layer = tl.Conv2D(4, 3, 3, border_mode="same", name="c")
    mods = layer.make_modules([(6, 6, 3)], torch.Generator().manual_seed(0))
    assert mods["c"].weight.dtype == torch.float32
    out = layer.apply(mods, [torch.randn(2, 6, 6, 3)], False)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 6, 6, 4)


@pytest.mark.parametrize("kernel", [(3, 3, 5, 7), (1, 1, 4, 6),
                                    (2, 3, 3, 4, 5), (3, 4, 2)])
@pytest.mark.parametrize("bias", [True, False])
def test_convert_round_trips_conv_kernels(kernel, bias):
    rng = np.random.RandomState(len(kernel))
    tree = {"c": {"kernel": rng.randn(*kernel).astype(np.float32)}}
    if bias:
        tree["c"]["bias"] = rng.randn(kernel[-1]).astype(np.float32)
    sd = flax_to_state_dict(tree)
    k = kernel
    assert sd["c.weight"].shape == (k[-1], int(np.prod(k[:-1])))
    back = state_dict_to_flax(sd, tree)
    for leaf in tree["c"]:
        np.testing.assert_array_equal(back["c"][leaf], tree["c"][leaf])


def test_conv_weight_views_are_channels_last_without_a_copy():
    from analytics_zoo_tpu_torch.common.flax_compat import Conv
    conv = Conv(3, 8, (3, 3))
    w = conv.torch_weight(torch.float32)
    assert w.shape == (8, 3, 3, 3)
    assert w.data_ptr() == conv.weight.data_ptr()
    assert w.is_contiguous(memory_format=torch.channels_last)
    conv3 = Conv(3, 8, (2, 3, 3))
    assert conv3.torch_weight(torch.float32).is_contiguous(
        memory_format=torch.channels_last_3d)
