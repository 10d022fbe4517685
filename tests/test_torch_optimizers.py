"""The eight optimizers of the port's ``learn/optimizers.py`` that follow
optax 0.2.6 (rmsprop, adagrad, adadelta, adamax, nadam, lars, lamb,
lbfgs) against the JAX package's wrappers, on the CPU.

- Five updates from the same parameters and the same gradients (those of
  a fixed quadratic at JAX's parameters, so L-BFGS sees a real
  curvature): every parameter within 1e-6 of its leaf's largest value.
  L-BFGS runs with a ring of 3, so the ring wraps.
- The state after those updates as ``optax_state`` gives it: the same
  tree, keys in flax's order, as ``flax.serialization.to_state_dict`` of
  optax's state, and every leaf within 1e-6 of its largest value (counts
  equal).
- Checkpoints both ways through the estimators: a JAX fit of two steps
  saved and loaded by the port, which re-encodes flax's bytes exactly;
  then two more steps in each package from there agree within 1e-5 of
  each leaf's largest value (the JAX step sums its 8 virtual devices'
  gradients in another order); and a port fit of two steps loaded by JAX,
  then two more steps in each. The JAX fits are shared through a
  module-scoped fixture.
- L-BFGS's memories carry a slot axis in front of each parameter's
  shape: the flax layout (BERT's ``[in, h, d]`` projections) applies past
  it, both ways.
- ``Optimizer.get`` builds all eleven names; ``LBFGS(linesearch=...)``
  raises as JAX's does; LBFGS beats SGD on least squares (JAX's
  ``test_lbfgs_optimizer_trains``).

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common.flax_compat import Dense
from analytics_zoo_tpu_torch.convert import (ParamLayout, flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
from analytics_zoo_tpu_torch.learn import estimator as est_lib
from analytics_zoo_tpu_torch.learn import optimizers as topt

# (id, class name, keyword arguments shared by both packages)
EIGHT = [
    ("rmsprop", "RMSprop", {"learningrate": 1e-2}),
    ("adagrad", "Adagrad", {"learningrate": 0.1}),
    ("adadelta", "Adadelta", {"learningrate": 1.0, "decayrate": 0.8}),
    ("adamax", "Adamax", {"learningrate": 1e-2}),
    ("nadam", "Nadam", {"learningrate": 1e-2}),
    ("lars", "LARS", {"learningrate": 0.1, "weight_decay": 1e-2}),
    ("lamb", "LAMB", {"learningrate": 1e-2, "weight_decay": 1e-2}),
    ("lbfgs", "LBFGS", {"learningrate": 0.5, "ncorrection": 3}),
]
IDS = [c[0] for c in EIGHT]
SHAPES = {"a": (4, 3), "b": (3,), "c": (2, 2, 2), "z": (3,)}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch, tmp_path):
    monkeypatch.setattr(est_lib, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import flax.linen as fnn
    from flax import serialization
    from analytics_zoo_tpu.learn import optimizers as jopt
    from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
    return dict(jax=jax, fnn=fnn, ser=serialization, opt=jopt,
                Estimator=JEstimator)


def _make(module, case):
    _, cls, kwargs = case
    return getattr(module, cls)(**kwargs)


def _close(got, want, share=1e-6, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= share * scale, (what, err, scale)


def _structure(tree):
    """Keys in order, recursively, with leaves' shapes."""
    if isinstance(tree, dict):
        return [(k, _structure(v)) for k, v in tree.items()]
    return tuple(np.shape(tree))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


# ------------------------------------------------------- updates and state

@pytest.fixture(scope="module")
def optax_runs(jx):
    """Per optimizer: the initial parameters, the five gradients, and
    JAX's parameters and optax state after them."""
    import jax.numpy as jnp
    import optax
    rng = np.random.RandomState(11)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    init["z"][:] = 0.0          # a zero norm: the trust ratio falls to 1
    curv = {k: rng.uniform(0.5, 2.0, s).astype(np.float32)
            for k, s in SHAPES.items()}
    target = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    out = {}
    for case in EIGHT:
        tx = _make(jx["opt"], case).to_optax()
        jp = {k: jnp.asarray(v) for k, v in init.items()}
        state = tx.init(jp)
        grads = []
        for _ in range(5):
            g = {k: (curv[k] * (np.asarray(jp[k]) - target[k])).astype(
                np.float32) for k in SHAPES}
            grads.append(g)
            upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
            jp = optax.apply_updates(jp, upd)
        out[case[0]] = (init, grads,
                        {k: np.asarray(v) for k, v in jp.items()},
                        jx["ser"].to_state_dict(
                            jx["jax"].tree_util.tree_map(np.asarray, state)))
    return out


def _port_run(case, init, grads):
    opt = _make(topt, case)
    tp = [torch.from_numpy(init[k].copy()) for k in SHAPES]
    state = {"count": 0, **opt.init(tp)}
    for g in grads:
        opt.step(tp, [torch.from_numpy(g[k]) for k in SHAPES], state,
                 state["count"])
        state["count"] += 1
    return opt, tp, state


def _tree(tensors, lead=()):
    return {k: t.detach().numpy().copy() for k, t in zip(SHAPES, tensors)}


@pytest.mark.parametrize("case", EIGHT, ids=IDS)
def test_five_updates_match_optax(optax_runs, case):
    init, grads, want, _ = optax_runs[case[0]]
    _, tp, _ = _port_run(case, init, grads)
    for k, t in zip(SHAPES, tp):
        _close(t.numpy(), want[k], what=k)
    # every update moved something
    assert any(not np.array_equal(t.numpy(), init[k])
               for k, t in zip(SHAPES, tp))


@pytest.mark.parametrize("case", EIGHT, ids=IDS)
def test_state_tree_is_optax_state(optax_runs, case):
    init, grads, _, want = optax_runs[case[0]]
    opt, _, state = _port_run(case, init, grads)
    got = opt.optax_state(state, _tree)
    assert _structure(got) == _structure(want)
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        if np.asarray(w).dtype.kind == "i":
            assert int(g) == int(w) == 5, path
        else:
            _close(g, w, what=path)
    # and back: from_optax_state inverts it
    back = opt.from_optax_state(
        got, lambda tree, lead=0: [torch.as_tensor(tree[k]) for k in SHAPES])
    again = opt.optax_state({**back, "count": 5}, _tree)
    for (path, g), (_, w) in zip(_leaves(again), _leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), path)


# ------------------------------------------------------------ checkpoints

class MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.hidden = Dense(6, 8)
        self.out = Dense(8, 2)

    def forward(self, x, train: bool = False):
        return self.out(torch.tanh(self.hidden(x)))


def _jax_mlp(fnn):
    class JMLP(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            return fnn.Dense(2, name="out")(
                fnn.tanh(fnn.Dense(8, name="hidden")(x)))
    return JMLP()


def _data():
    rng = np.random.RandomState(5)
    x = rng.randn(32, 6).astype(np.float32)
    y = np.stack([x[:, :3].sum(1), x[:, 3:].sum(1)], 1).astype(np.float32)
    return x, y


def _jest(jx, case, x):
    return jx["Estimator"].from_flax(
        model=_jax_mlp(jx["fnn"]), loss="mse",
        optimizer=_make(jx["opt"], case), sample_input=x[:2], seed=0)


def _test(case, params=None):
    module = MLP()
    if params is not None:
        module.load_state_dict(flax_to_state_dict(params))
    return Estimator.from_torch(model=module, loss="mse",
                                optimizer=_make(topt, case), device="cpu")


def _latest_bytes(path):
    found = ckpt.find_latest_checkpoint(path)
    with open(f"{found[0]}/state.msgpack", "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def jax_ckpts(jx, tmp_path_factory):
    """Per optimizer: JAX's initial parameters, its checkpoint after two
    steps, its parameters two steps later, and, from a port checkpoint
    after two steps (made from the same initial parameters), JAX's
    parameters two steps later."""
    jax = jx["jax"]
    x, y = _data()
    out = {}
    for case in EIGHT:
        root = tmp_path_factory.mktemp(case[0])
        j = _jest(jx, case, x)
        p0 = jax.device_get(j.adapter.params)
        j.fit((x, y), epochs=1, batch_size=16, shuffle=False)
        j.save(str(root / "j"))
        j.fit((x, y), epochs=1, batch_size=16, shuffle=False)
        after_j = jax.device_get(j._state["params"])
        t = _test(case, p0)
        t.fit((x, y), epochs=1, batch_size=16, shuffle=False)
        t.save(str(root / "t"))
        j2 = _jest(jx, case, x)
        j2.load(str(root / "t"))
        j2.fit((x, y), epochs=1, batch_size=16, shuffle=False)
        out[case[0]] = dict(p0=p0, root=root, after_j=after_j,
                            after_t=jax.device_get(j2._state["params"]))
    return out


def _params_close(module, want, share=1e-5):
    got = state_dict_to_flax(module.state_dict(), want)
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        _close(g, w, share, path)


@pytest.mark.parametrize("case", EIGHT, ids=IDS)
def test_checkpoints_cross_both_ways(jax_ckpts, case):
    rec = jax_ckpts[case[0]]
    x, y = _data()
    # JAX's checkpoint in the port: flax's bytes come back exactly
    t = _test(case).load(str(rec["root"] / "j"))
    assert t._py_step == 2
    assert ckpt.to_bytes(t._state_tree()) == _latest_bytes(
        str(rec["root"] / "j"))
    t.fit((x, y), epochs=1, batch_size=16, shuffle=False)
    _params_close(t.model, rec["after_j"])
    # the port's checkpoint in JAX (the fixture's j2), two more steps in
    # each package from the same file
    t2 = _test(case).load(str(rec["root"] / "t"))
    t2.fit((x, y), epochs=1, batch_size=16, shuffle=False)
    _params_close(t2.model, rec["after_t"])


def test_lbfgs_memories_keep_the_flax_layout_past_the_slot_axis():
    """BERT's attention projections (``[in, h, d]`` kernels, ``[h, d]``
    biases, an ``[h, d, out]`` output) with a slot axis in front: each
    slot transforms as the parameters do, both ways."""
    from analytics_zoo_tpu_torch.ops.attention import AttentionModule
    torch.manual_seed(0)
    module = AttentionModule(num_heads=2, head_dim=3, q_features=6)
    layout = ParamLayout(module)
    named = dict(module.named_parameters())
    slots = {n: torch.randn((4,) + p.shape) for n, p in named.items()}
    tree = layout.to_tree(slots, lead=(4,))
    for i in range(4):
        one = layout.to_tree({n: t[i] for n, t in slots.items()})
        for (path, g), (_, w) in zip(_leaves(tree), _leaves(one)):
            np.testing.assert_array_equal(g[i], w, path)
    assert tree["query"]["kernel"].shape == (4, 6, 2, 3)
    assert tree["out"]["kernel"].shape == (4, 2, 3, 6)
    back = layout.from_tree(tree, lead=1)
    for n, t in slots.items():
        assert torch.equal(back[n], t), n
    spec = layout.spec((4,))
    assert tuple(spec["query"]["bias"].shape) == (4, 2, 3)


# ------------------------------------------------------------- the surface

def test_every_jax_name_builds():
    names = {"sgd": topt.SGD, "adam": topt.Adam,
             "adamw": topt.AdamWeightDecay, "rmsprop": topt.RMSprop,
             "adagrad": topt.Adagrad, "adadelta": topt.Adadelta,
             "adamax": topt.Adamax, "nadam": topt.Nadam, "lars": topt.LARS,
             "lamb": topt.LAMB, "lbfgs": topt.LBFGS}
    for name, cls in names.items():
        assert type(topt.Optimizer.get(name.upper())) is cls
    with pytest.raises(ValueError, match="line-search"):
        topt.LBFGS(linesearch=lambda *a: None)
    with pytest.raises(ValueError, match="memory_size"):
        topt.LBFGS(ncorrection=0)


def test_lbfgs_beats_sgd_on_least_squares():
    """JAX's ``test_lbfgs_optimizer_trains``: full-batch least squares,
    12 epochs: LBFGS(1.0, ncorrection=10) below 1e-3 and below SGD."""
    rng = np.random.RandomState(0)
    x = rng.randn(128, 6).astype(np.float32)
    y = x @ rng.randn(6, 1).astype(np.float32)

    def final_loss(opt):
        torch.manual_seed(0)
        est = Estimator.from_torch(model=torch.nn.Linear(6, 1, bias=False),
                                   loss="mse", optimizer=opt, device="cpu")
        est.fit((x, y), epochs=12, batch_size=128)
        return est.evaluate((x, y), batch_size=128)["loss"]

    lbfgs = final_loss(topt.LBFGS(learningrate=1.0, ncorrection=10))
    sgd = final_loss("sgd")
    assert np.isfinite(lbfgs) and lbfgs < sgd
    assert lbfgs < 1e-3
