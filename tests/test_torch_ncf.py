"""The port's NeuralCF and keras engine against the JAX package's.

A JAX model is initialised in flax, its parameters go through
``analytics_zoo_tpu_torch.convert.flax_to_state_dict`` into the port, and
both predict on the same numpy inputs. fp32 outputs agree within
rtol=1e-5, atol=1e-6: the two frameworks order their matmul sums and
softmax reductions differently. Everything runs on the CPU
(``device="cpu"``); the JAX lookup runs its plain reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import Sequential as JSequential
from analytics_zoo_tpu.keras import layers as jl
from analytics_zoo_tpu.models.recommendation import NeuralCF as JNeuralCF
from analytics_zoo_tpu_torch.convert import flax_to_state_dict
from analytics_zoo_tpu_torch.data import HostXShards
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras import Sequential, layers as tl, policy
from analytics_zoo_tpu_torch.models import NeuralCF, ZooModel
from analytics_zoo_tpu_torch.models.recommendation import UserItemFeature

RTOL, ATOL = 1e-5, 1e-6
USERS, ITEMS = 50, 30


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny shapes: one intra-op thread, so parallel test workers do not
    # oversubscribe the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ncf_args(include_mf):
    return dict(user_count=USERS, item_count=ITEMS, class_num=5,
                user_embed=8, item_embed=6, hidden_layers=(16, 8),
                include_mf=include_mf, mf_embed=7 if include_mf else 0)


def _pairs(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(1, USERS + 1, n),
                     rng.randint(1, ITEMS + 1, n)], 1).astype(np.float32)


def _jax_model(net, x):
    mod = net.to_flax()
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    return mod, variables


def _port_pair(include_mf):
    """(JAX prediction fn, port NeuralCF holding the same parameters)."""
    jncf = JNeuralCF(**_ncf_args(include_mf))
    x = _pairs()
    mod, variables = _jax_model(jncf.model, x)
    ncf = NeuralCF(**_ncf_args(include_mf))
    ncf.model.module.load_state_dict(
        flax_to_state_dict(jax.device_get(variables["params"])))
    return (lambda a: np.asarray(mod.apply(variables, jnp.asarray(a)))), \
        ncf, variables


@pytest.mark.parametrize("include_mf", [True, False])
def test_ncf_predict_matches_jax(include_mf):
    jax_predict, ncf, _ = _port_pair(include_mf)
    x = _pairs(100, seed=1)
    want = jax_predict(x)
    got = ncf.predict(x, batch_size=32, device="cpu")
    assert got.shape == (100, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("include_mf", [True, False])
def test_ncf_param_names_match_flax_tree(include_mf):
    _, ncf, variables = _port_pair(include_mf)
    params = jax.device_get(variables["params"])
    leaf = {"kernel": "weight", "bias": "bias", "embedding": "embedding"}
    want = {f"{m}.{leaf[k]}": (tuple(v.shape[::-1]) if k == "kernel"
                               else tuple(v.shape))
            for m, sub in params.items() for k, v in sub.items()}
    got = {k: tuple(v.shape) for k, v in ncf.model.module.state_dict().items()}
    assert got == want
    assert {"mlp_user_embed.embedding", "mlp_item_embed.embedding",
            "dense_1.weight"} <= set(got)


@pytest.mark.parametrize("include_mf", [True, False])
def test_save_load_roundtrip(tmp_path, include_mf):
    _, ncf, _ = _port_pair(include_mf)
    x = _pairs(20, seed=2)
    ncf.save_model(str(tmp_path / "m"))
    with pytest.raises(FileExistsError):
        ncf.save_model(str(tmp_path / "m"))
    back = ZooModel.load_model(str(tmp_path / "m"))
    assert isinstance(back, NeuralCF)
    np.testing.assert_array_equal(back.predict(x, device="cpu"),
                                  ncf.predict(x, device="cpu"))
    im = InferenceModel(device="cpu").load(str(tmp_path / "m"))
    np.testing.assert_array_equal(im.predict(x), ncf.predict(x, device="cpu"))


def test_inference_model_chunks_and_ladder_match_direct_predict():
    _, ncf, _ = _port_pair(True)
    x = _pairs(45, seed=3)
    want = ncf.predict(x, device="cpu")
    im = InferenceModel(device="cpu").load_zoo(ncf)
    np.testing.assert_allclose(im.predict(x, batch_size=16), want,
                               rtol=RTOL, atol=ATOL)
    im.set_ladder(4, 32)
    np.testing.assert_allclose(im.predict(x), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        im.predict_fetch(im.predict_async(x[:8])), want[:8],
        rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(im.predict_classes(x), want.argmax(-1))
    # a stream of batches
    np.testing.assert_allclose(im.predict(iter([x[:20], x[20:]])), want,
                               rtol=RTOL, atol=ATOL)


def test_inference_model_holds_a_copy():
    _, ncf, _ = _port_pair(True)
    x = _pairs(8, seed=4)
    im = InferenceModel(device="cpu").load_zoo(ncf)
    before = im.predict(x)
    with torch.no_grad():
        for p in ncf.model.module.parameters():
            p.zero_()
    np.testing.assert_array_equal(im.predict(x), before)


def test_predict_user_item_pair_matches_jax():
    jax_predict, ncf, _ = _port_pair(True)
    x = _pairs(12, seed=5)
    probs = jax_predict(x)
    got = ncf.predict_user_item_pair(
        [UserItemFeature(int(u), int(i), np.array([u, i]))
         for u, i in x], device="cpu")
    assert isinstance(got, HostXShards)
    got = got.collect()[0]
    assert [p.prediction for p in got] == list(probs.argmax(-1) + 1)
    np.testing.assert_allclose([p.probability for p in got],
                               probs.max(-1), rtol=RTOL, atol=ATOL)


def test_zoo_model_predict_passes_its_arguments_through():
    # JAX's ZooModel.predict(*args, **kwargs): distributed= is accepted
    jax_predict, ncf, _ = _port_pair(True)
    x = _pairs(10, seed=6)
    got = ncf.predict(x, batch_size=4, distributed=False, device="cpu")
    np.testing.assert_allclose(got, jax_predict(x), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ncf.predict(x, 4, False, "cpu"), got)


def test_two_builds_get_the_same_names():
    a = NeuralCF(**_ncf_args(True)).model.module.state_dict()
    b = NeuralCF(**_ncf_args(True)).model.module.state_dict()
    assert list(a) == list(b)
    for k in a:   # same seed, same values
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_sequential_layers_match_jax():
    x = np.random.RandomState(6).randn(10, 3, 4).astype(np.float32)

    def build(L, S):
        return (S().add(L.Flatten(input_shape=(3, 4)))
                .add(L.Dense(8, activation="gelu"))
                .add(L.Dropout(0.5))
                .add(L.Activation("tanh"))
                .add(L.Dense(5, activation="log_softmax")))

    jmodel = build(jl, JSequential)
    mod, variables = _jax_model(jmodel, x)
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    port = build(tl, Sequential)
    port.module.load_state_dict(
        flax_to_state_dict(jax.device_get(variables["params"])))
    np.testing.assert_allclose(port.predict(x, device="cpu"), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["sum", "mul", "ave", "max", "concat",
                                  "dot", "cos"])
def test_merge_modes_match_jax(mode):
    from analytics_zoo_tpu.keras import Input as JInput, Model as JModel
    from analytics_zoo_tpu_torch.keras import Input, Model

    rng = np.random.RandomState(7)
    a, b = (rng.randn(6, 4).astype(np.float32) for _ in range(2))

    def build(L, I, M):
        i1, i2 = I(shape=(4,)), I(shape=(4,))
        return M(input=[i1, i2], output=L.merge([i1, i2], mode=mode))

    jm = build(jl, JInput, JModel).to_flax()
    want = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0), a, b), a, b))
    got = build(tl, Input, Model).predict((a, b), device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bf16_policy_casts_tables_before_lookup():
    with policy.policy_scope("mixed_bfloat16"):
        ncf = NeuralCF(**_ncf_args(True))
    out = ncf.predict(_pairs(8), device="cpu")
    assert out.shape == (8, 5) and np.isfinite(out).all()
    with pytest.raises(ValueError):
        policy.set_dtype_policy("float16")


def test_models_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NeuralCF(**_ncf_args(True)).predict(_pairs(4))
