"""The port's losses, optimizers, schedules, clipping and metrics against
the JAX package's (``analytics_zoo_tpu/learn``) and optax.

- Every loss of the registry, one parametrised case each (plus a bf16
  prediction and a sequence case), on the same numpy inputs: within rtol
  1e-5 / atol 1e-6 (fp32 elementwise math and one reduction, in another
  order).
- Optimizers: ``Adam``, ``AdamWeightDecay`` (plain and with
  ``total``/``warmup_portion``), and ``SGD`` with momentum, Nesterov and
  weight decay, with and without schedules, take 5 steps from the same
  parameters and gradients as their optax transformations: parameters
  within rtol 1e-5 / atol 1e-6 (the same fp32 update rule; a rounding
  flip of the bias correction or the square root moves the last bits).
- Schedules against optax's functions at counts 0..12, within rtol 1e-5
  (optax evaluates them in fp32, the port in double).
- Clipping against ``optax.clip_by_global_norm`` (above and below the
  limit) and ``optax.clip``, within rtol 1e-6.
- Every metric of the registry over two batches, the second one masked,
  within rtol 1e-5 / atol 1e-6.

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.learn import losses as tlosses
from analytics_zoo_tpu_torch.learn import metrics as tmetrics
from analytics_zoo_tpu_torch.learn import optimizers as topt
from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator

B, C = 8, 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jlearn():
    """The JAX package's losses, metrics and optimizers modules."""
    pytest.importorskip("jax")
    from analytics_zoo_tpu.learn import losses, metrics, optimizers
    return losses, metrics, optimizers


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _loss_inputs(name, rng):
    """(y_true, y_pred) numpy arrays that suit loss ``name``."""
    pos = rng.uniform(0.1, 2.0, (B, 3)).astype(np.float32)
    logits = rng.randn(B, C).astype(np.float32)
    labels = rng.randint(0, C, B).astype(np.int32)
    if name == "binary_crossentropy":
        return (rng.randint(0, 2, (B, 1)).astype(np.float32),
                rng.uniform(0.01, 0.99, (B, 1)).astype(np.float32))
    if name == "bce_logits":
        return rng.randint(0, 2, (B, 3)).astype(np.float32), logits[:, :3]
    if name == "categorical_crossentropy":
        return np.eye(C, dtype=np.float32)[labels], _softmax(logits)
    if name == "sparse_categorical_crossentropy":
        return labels, _softmax(logits)
    if name == "sparse_categorical_crossentropy_logits":
        return labels, logits
    if name == "kld":
        return _softmax(rng.randn(B, C)), _softmax(logits)
    if name in ("hinge", "squared_hinge"):
        return np.sign(rng.randn(B, 3)).astype(np.float32), \
            rng.randn(B, 3).astype(np.float32)
    if name in ("mse", "mean_squared_error", "mae", "mean_absolute_error",
                "huber", "cosine_proximity"):
        return rng.randn(B, 3).astype(np.float32), \
            rng.randn(B, 3).astype(np.float32)
    return pos, rng.uniform(0.1, 2.0, (B, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(tlosses._REGISTRY))
def test_loss_matches_jax(jlearn, name):
    jl = jlearn[0]
    y_true, y_pred = _loss_inputs(name, np.random.RandomState(
        sorted(tlosses._REGISTRY).index(name)))
    want = np.asarray(jl.get(name)(y_true, y_pred))
    got = tlosses.get(name)(torch.from_numpy(y_true),
                            torch.from_numpy(y_pred))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["sparse_categorical_crossentropy_logits",
                                  "mse", "msle"])
def test_loss_computes_bf16_predictions_in_fp32(jlearn, name):
    import jax.numpy as jnp
    jl = jlearn[0]
    y_true, y_pred = _loss_inputs(name, np.random.RandomState(3))
    want = np.asarray(jl.get(name)(y_true, jnp.asarray(y_pred, jnp.bfloat16)))
    got = tlosses.get(name)(torch.from_numpy(y_true),
                            torch.from_numpy(y_pred).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_sequence_cross_entropy_means_over_time(jlearn):
    rng = np.random.RandomState(4)
    logits = rng.randn(B, 6, C).astype(np.float32)
    labels = rng.randint(0, C, (B, 6)).astype(np.int32)
    name = "sparse_categorical_crossentropy_logits"
    want = np.asarray(jlearn[0].get(name)(labels, logits))
    got = tlosses.get(name)(torch.from_numpy(labels),
                            torch.from_numpy(logits))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# labels out of range: JAX's take_along_axis fills NaN, negative labels in
# [-C, 0) wrap (ROADMAP C9); uniform 0.2 predictions over 5 classes
OUT_OF_RANGE = np.array([0, 4, 5, -1, -6, 7, -5], np.int32)
SPARSE_NAMES = ["sparse_categorical_crossentropy",
                "sparse_categorical_crossentropy_logits"]


def _out_of_range_inputs(name):
    n = len(OUT_OF_RANGE)
    if name.endswith("_logits"):
        return OUT_OF_RANGE, np.zeros((n, C), np.float32)
    return OUT_OF_RANGE, np.full((n, C), 0.2, np.float32)


def _assert_same_nans(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", SPARSE_NAMES)
def test_sparse_loss_labels_out_of_range_give_nan_as_jax(jlearn, name):
    y_true, y_pred = _out_of_range_inputs(name)
    want = np.asarray(jlearn[0].get(name)(y_true, y_pred))
    got = tlosses.get(name)(torch.from_numpy(y_true),
                            torch.from_numpy(y_pred)).numpy()
    # 1.609438 = -log(0.2) at 0, 4, -1 and -5; NaN at 5, -6 and 7
    assert np.isnan(want).tolist() == [False, False, True, False, True,
                                       True, False]
    np.testing.assert_allclose(want[0], 1.609438, rtol=1e-6)
    _assert_same_nans(got, want)


def test_sparse_metric_labels_out_of_range_give_nan_as_jax(jlearn):
    import jax.numpy as jnp
    name = "sparse_categorical_crossentropy"
    y_true, y_pred = _out_of_range_inputs(name)
    jm, tm = jlearn[1].get(name), tmetrics.get(name)
    _assert_same_nans(tm._per_sample(torch.from_numpy(y_true),
                                     torch.from_numpy(y_pred)).numpy(),
                      jm._per_sample(jnp.asarray(y_true),
                                     jnp.asarray(y_pred)))
    # a label in range everywhere but one row: the running result is NaN
    state = tm.update(tm.init_state(), torch.from_numpy(y_true),
                      torch.from_numpy(y_pred))
    assert np.isnan(tm.result(state))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPARSE_NAMES)
def test_cuda_sparse_loss_labels_out_of_range_give_nan(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    y_true, y_pred = _out_of_range_inputs(name)
    want = tlosses.get(name)(torch.from_numpy(y_true),
                             torch.from_numpy(y_pred))
    got = tlosses.get(name)(torch.from_numpy(y_true).cuda(),
                            torch.from_numpy(y_pred).cuda())
    torch.cuda.synchronize()   # a device assert would surface here
    _assert_same_nans(got.cpu().numpy(), want.numpy())
    metric = tmetrics.get("sparse_categorical_crossentropy")
    _assert_same_nans(
        metric._per_sample(torch.from_numpy(y_true).cuda(),
                           torch.softmax(torch.from_numpy(y_pred).cuda(),
                                         -1)).cpu().numpy(),
        metric._per_sample(torch.from_numpy(y_true),
                           torch.softmax(torch.from_numpy(y_pred),
                                         -1)).numpy())


def test_loss_lookup_errors():
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.get("nope")
    with pytest.raises(TypeError):
        tlosses.get(3)
    assert tlosses.get(tlosses.huber) is tlosses.huber


# ------------------------------------------------------------- optimizers

# (id, optimizer class name, kwargs, schedule class name or None, its args)
OPTIMIZERS = [
    ("adam", "Adam", {}, None, ()),
    ("adam_lr_poly", "Adam", {"learningrate": 1e-2}, "Poly", (2.0, 6)),
    ("adamw", "AdamWeightDecay", {"learningrate": 1e-2}, None, ()),
    ("adamw_warmup_cosine", "AdamWeightDecay",
     {"learningrate": 1e-2, "weight_decay": 0.1, "total": 8,
      "warmup_portion": 0.3}, None, ()),
    ("sgd", "SGD", {"learningrate": 0.1}, None, ()),
    ("sgd_momentum", "SGD", {"learningrate": 0.1, "momentum": 0.9}, None,
     ()),
    ("sgd_nesterov_wd_step", "SGD",
     {"learningrate": 0.1, "momentum": 0.9, "nesterov": True,
      "weightdecay": 0.01}, "Step", (2, 0.5)),
    ("sgd_exponential", "SGD", {"learningrate": 0.1}, "Exponential",
     (3, 0.7)),
    ("sgd_warmup", "SGD", {"learningrate": 0.1, "momentum": 0.5}, "Warmup",
     (3,)),
    ("adam_warmup_cosine", "Adam", {"learningrate": 1e-2}, "WarmupCosine",
     (2, 6)),
]


def _build(module, cls, kwargs, sched, sargs):
    kw = dict(kwargs)
    if sched is not None:
        kw["leaningrate_schedule"] = getattr(module, sched)(*sargs)
    return getattr(module, cls)(**kw)


@pytest.mark.parametrize("case", OPTIMIZERS, ids=[c[0] for c in OPTIMIZERS])
def test_optimizer_steps_match_optax(jlearn, case):
    import jax.numpy as jnp
    import optax
    _, cls, kwargs, sched, sargs = case
    rng = np.random.RandomState(7)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(5)]

    tx = _build(jlearn[2], cls, kwargs, sched, sargs).to_optax()
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)

    opt = _build(topt, cls, kwargs, sched, sargs)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for count, g in enumerate(grads):
        opt.step(tp, [torch.from_numpy(a) for a in g], tstate, count)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sched,args", [
    ("Poly", (2.0, 10)), ("Exponential", (3, 0.7)),
    ("Exponential", (3, 0.7, True)), ("Step", (4, 0.5)), ("Warmup", (5,)),
    ("WarmupCosine", (3, 10)), ("WarmupCosine", (3, 10, 1e-4)),
    ("Default", ())])
def test_schedules_match_optax(jlearn, sched, args):
    want = getattr(jlearn[2], sched)(*args).to_optax(0.05)
    got = getattr(topt, sched)(*args).build(0.05)
    for count in range(13):
        w = want(count) if callable(want) else want
        np.testing.assert_allclose(got(count), float(w), rtol=1e-5,
                                   atol=1e-12)


def test_adamw_warmup_portion_schedule(jlearn):
    import optax
    opt = topt.AdamWeightDecay(learningrate=0.1, total=10,
                               warmup_portion=0.25)
    want = optax.warmup_cosine_decay_schedule(0.0, 0.1, 2, 10)
    for count in range(12):
        np.testing.assert_allclose(opt._lr(count), float(want(count)),
                                   rtol=1e-5, atol=1e-12)


def test_optimizers_not_ported_raise_with_their_roadmap_item():
    # A3 ported the last eight names (tests/test_torch_optimizers.py): none
    # raises now, and an unknown name still does
    for name in ("rmsprop", "lamb", "lbfgs"):
        assert type(topt.Optimizer.get(name)).__name__ == {
            "rmsprop": "RMSprop", "lamb": "LAMB", "lbfgs": "LBFGS"}[name]
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.Optimizer.get("nope")
    assert isinstance(topt.Optimizer.get("ADAMW"), topt.AdamWeightDecay)


# ------------------------------------------------------------- clipping

@pytest.mark.parametrize("kind,arg", [("norm", 0.5), ("norm", 100.0),
                                      ("const", (-0.3, 0.2))])
def test_clipping_matches_optax(jlearn, kind, arg):
    import jax.numpy as jnp
    import optax
    rng = np.random.RandomState(9)
    grads = [rng.randn(4, 3).astype(np.float32),
             rng.randn(5).astype(np.float32)]
    est = TorchEstimator(torch.nn.Linear(2, 2), loss="mse", device="cpu")
    if kind == "norm":
        est.set_l2_norm_gradient_clipping(arg)
        tx = optax.clip_by_global_norm(arg)
    else:
        est.set_constant_gradient_clipping(*arg)
        tx = optax.clip(max(abs(arg[0]), abs(arg[1])))
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    got = est._clip([torch.from_numpy(g) for g in grads])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    est.clear_gradient_clipping()
    assert est._clip(got) is got


# ------------------------------------------------------------- metrics

def _metric_inputs(name, rng, n):
    logits = rng.randn(n, C).astype(np.float32)
    labels = rng.randint(0, C, n).astype(np.int32)
    if name in ("binary_accuracy", "auc", "binary_crossentropy"):
        return (rng.randint(0, 2, (n, 1)).astype(np.float32),
                rng.uniform(0.01, 0.99, (n, 1)).astype(np.float32))
    if name in ("categorical_accuracy", "categorical_crossentropy"):
        return np.eye(C, dtype=np.float32)[labels], _softmax(logits)
    if name in ("accuracy", "acc", "sparse_categorical_accuracy",
                "top5", "top5_accuracy"):
        return labels, logits
    if name == "sparse_categorical_crossentropy":
        return labels, _softmax(logits)
    if name in ("kld", "kullback_leibler_divergence"):
        return _softmax(rng.randn(n, C)), _softmax(logits)
    if name == "poisson":
        return (rng.uniform(0, 3, (n, 1)).astype(np.float32),
                rng.uniform(0.1, 3, (n, 1)).astype(np.float32))
    return rng.randn(n, 2).astype(np.float32), \
        rng.randn(n, 2).astype(np.float32)


@pytest.mark.parametrize("name", sorted(tmetrics._REGISTRY))
def test_metric_matches_jax(jlearn, name):
    import jax.numpy as jnp
    jm = jlearn[1].get(name)
    tm = tmetrics.get(name)
    assert tm.name == jm.name
    rng = np.random.RandomState(len(name))
    batches = [_metric_inputs(name, rng, 12) for _ in range(2)]
    mask = np.array([1] * 7 + [0] * 5, np.float32)
    js, ts = jm.init_state(), tm.init_state()
    for (y, p), m in zip(batches, (None, mask)):
        js = jm.update(js, jnp.asarray(y), jnp.asarray(p),
                       None if m is None else jnp.asarray(m))
        ts = tm.update(ts, torch.from_numpy(y), torch.from_numpy(p),
                       None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(tm.result(ts), jm.result(js), rtol=1e-5,
                               atol=1e-6)


def test_metric_lookup_errors():
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.get("nope")
    acc = tmetrics.Accuracy()
    assert tmetrics.get(acc) is acc
