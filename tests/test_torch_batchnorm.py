"""``BatchNormalization`` in the port against flax's ``nn.BatchNorm``
through the JAX package's keras layer, on the CPU.

flax's semantics are not ``torch.nn.BatchNorm2d``'s: statistics in fp32
(also for a bf16 input), the *biased* variance normalises and enters the
running one, and the running statistics move as ``ra = m * ra + (1 - m) *
batch`` (``m = momentum``: 0.99 by default, 0.9 in ResNet-50), with no
``num_batches_tracked``. Held, from the same parameters and inputs
(channels-last, with an offset and a spread per channel):

- train- and eval-mode outputs within 1e-5 absolute (measured: at most
  1.9e-6 on outputs up to about 8: flax's ``E[x^2] - E[x]^2`` against
  torch's batch-norm kernel, in fp32 both);
- the running mean and variance after 3 train steps at momentum 0.99 and
  0.9, on 4-D and 2-D inputs, within rtol 2e-6 / atol 1e-6 (measured: at
  most 1.2e-6 absolute, 4.8e-7 relative, a few fp32 ulps);
- under ``mixed_bfloat16``: a bf16 output within one bf16 ulp of its
  largest value and fp32 running statistics within the same limits;
- the estimator's ``model_state`` is flax's ``{"batch_stats": {<layer>:
  {"mean", "var"}}}`` and no ``num_batches_tracked`` appears anywhere;
- ``fit`` moves the statistics (train mode), ``evaluate`` and ``predict``
  do not (eval mode);
- the step's flop count leaves every running statistic bit for bit as it
  was, and a fit with the count ends bitwise where one without it ends.

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import flatten, flax_to_state_dict
from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.keras import policy as tpolicy

OUT_ATOL = 1e-5
STATS_RTOL, STATS_ATOL = 2e-6, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch, tmp_path):
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
    import flax.linen as fnn
    from analytics_zoo_tpu.keras import layers as jl
    from analytics_zoo_tpu.keras import policy as jpolicy
    return dict(jax=jax, nn=fnn, jl=jl, policy=jpolicy)


def _batch(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (rng.randn(*shape) * rng.uniform(0.5, 3.0, c)
            + rng.uniform(-2.0, 2.0, c)).astype(np.float32)


def _pair(jx, dtype="float32", **kw):
    with jx["policy"].policy_scope(dtype), tpolicy.policy_scope(dtype):
        return (jx["jl"].BatchNormalization(name="bn", **kw),
                tl.BatchNormalization(name="bn", **kw))


def _jax_wrapper(jx, layer):
    fnn = jx["nn"]

    class W(fnn.Module):
        @fnn.compact
        def __call__(self, a, train=False):
            return layer.apply(layer.make_module(), [a], train)

    return W()


def _setup(jx, shape, dtype="float32", **kw):
    jlayer, tlayer = _pair(jx, dtype, **kw)
    w = _jax_wrapper(jx, jlayer)
    variables = jx["jax"].device_get(
        w.init(jx["jax"].random.PRNGKey(0), _batch(shape, 99)))
    rng = np.random.RandomState(7)
    c = shape[-1]
    # non-trivial scale, bias and running statistics
    variables = {
        "params": {"bn": {"scale": rng.uniform(0.5, 1.5, c).astype(
            np.float32), "bias": rng.randn(c).astype(np.float32)}},
        "batch_stats": {"bn": {"mean": rng.randn(c).astype(np.float32),
                               "var": rng.uniform(0.5, 2.0, c).astype(
                                   np.float32)}}}
    mods = torch.nn.ModuleDict(tlayer.make_modules(
        [shape[1:]], torch.Generator().manual_seed(0)))
    sd = flax_to_state_dict(variables["params"])
    sd.update(flax_to_state_dict(variables["batch_stats"]))
    mods.load_state_dict(sd, strict=True)
    return w, variables, tlayer, mods


def _jax_step(jx, w, variables, x, train):
    if train:
        out, mut = w.apply(variables, x, train=True, mutable=["batch_stats"])
        variables = {**variables, **jx["jax"].device_get(mut)}
    else:
        out = w.apply(variables, x)
    return np.asarray(out.astype("float32")), out.dtype, variables


@pytest.mark.parametrize("shape", [(8, 5, 6, 4), (16, 6)])
@pytest.mark.parametrize("momentum,eps", [(0.99, 1e-3), (0.9, 1e-5)])
def test_train_and_eval_match_flax(jx, shape, momentum, eps):
    w, variables, tlayer, mods = _setup(jx, shape, momentum=momentum,
                                        epsilon=eps)
    for step in range(3):
        x = _batch(shape, step)
        want, _, variables = _jax_step(jx, w, variables, x, train=True)
        got = tlayer.apply(dict(mods.items()), [torch.from_numpy(x)], True)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=OUT_ATOL)
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(mods["bn"], leaf).numpy(),
                variables["batch_stats"]["bn"][leaf], rtol=STATS_RTOL,
                atol=STATS_ATOL)
    x = _batch(shape, 10)
    want, _, _ = _jax_step(jx, w, variables, x, train=False)
    before = {k: v.clone() for k, v in mods.state_dict().items()}
    got = tlayer.apply(dict(mods.items()), [torch.from_numpy(x)], False)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=OUT_ATOL)
    for k, v in mods.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_mixed_bfloat16_keeps_fp32_statistics(jx):
    shape = (8, 4, 4, 6)
    w, variables, tlayer, mods = _setup(jx, shape, dtype="mixed_bfloat16",
                                        momentum=0.9, epsilon=1e-5)
    for step in range(3):
        x = _batch(shape, step)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        want, dt, variables = _jax_step(
            jx, w, variables, jx["jax"].numpy.asarray(x).astype("bfloat16"),
            train=True)
        got = tlayer.apply(dict(mods.items()), [xb], True)
        assert got.dtype == torch.bfloat16 and str(dt) == "bfloat16"
        limit = 2.0 ** -8 * float(np.abs(want).max())
        assert float(np.abs(got.detach().float().numpy() - want).max()) \
            <= limit
        for leaf in ("mean", "var"):
            buf = getattr(mods["bn"], leaf)
            assert buf.dtype == torch.float32
            ref = variables["batch_stats"]["bn"][leaf]
            assert ref.dtype == np.float32
            np.testing.assert_allclose(buf.numpy(), ref, rtol=STATS_RTOL,
                                       atol=STATS_ATOL)
    assert mods["bn"].weight.dtype == torch.float32


def _bn_model(seed=0):
    inp = Input(shape=(6, 6, 3))
    h = tl.Conv2D(4, 3, 3, border_mode="same")(inp)
    h = tl.BatchNormalization(momentum=0.9)(h)
    h = tl.Activation("relu")(h)
    h = tl.GlobalAveragePooling2D()(h)
    h = tl.Dense(6)(h)
    h = tl.BatchNormalization()(h)
    return Model(input=inp, output=tl.Dense(2, activation="softmax")(h),
                 seed=seed)


def _data(n=32):
    rng = np.random.RandomState(3)
    return (rng.randn(n, 6, 6, 3).astype(np.float32) + 0.5,
            rng.randint(0, 2, n).astype(np.int32))


def _stats(model):
    return {k: v.clone() for k, v in model.module.state_dict().items()
            if k.endswith((".mean", ".var"))}


def test_model_state_is_flax_batch_stats():
    model = _bn_model()
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  device="cpu")
    est = model.estimator
    for tree in (est._state_tree(), est._state_tree(spec=True)):
        ms = tree["model_state"]
        assert list(ms) == ["batch_stats"]
        assert sorted(ms["batch_stats"]) == ["batchnormalization_1",
                                             "batchnormalization_2"]
        assert sorted(flatten(ms)) == [
            f"batch_stats.batchnormalization_{i}.{leaf}"
            for i in (1, 2) for leaf in ("mean", "var")]
        assert set(tree["params"]["batchnormalization_1"]) == {"scale",
                                                              "bias"}
    assert not any("num_batches_tracked" in k
                   for k in model.module.state_dict())


def test_fit_moves_the_statistics_and_evaluate_and_predict_do_not():
    model = _bn_model()
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  device="cpu")
    x, y = _data()
    s0 = _stats(model)
    model.fit(x, y, batch_size=8, nb_epoch=1)
    s1 = _stats(model)
    assert all(not torch.equal(s0[k], s1[k]) for k in s0)
    model.evaluate(x, y, batch_size=8)
    model.predict(x, batch_size=8)
    s2 = _stats(model)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_the_flop_count_leaves_the_statistics_unchanged():
    model = _bn_model()
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  device="cpu")
    est = model.estimator
    x, y = _data(8)
    before = _stats(model)
    assert est._step_flops(x, y) > 0
    after = _stats(model)
    assert all(torch.equal(before[k], after[k]) for k in before)

    def run(count):
        m = _bn_model(seed=1)
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  device="cpu")
        if not count:
            m.estimator._step_flops = lambda x, y: None
        hist = m.fit(*_data(), batch_size=8, nb_epoch=2)
        return hist, m.module.state_dict()

    (h1, s1), (h2, s2) = run(True), run(False)
    assert h1 == h2
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
