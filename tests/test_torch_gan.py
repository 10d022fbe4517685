"""The port's ``GANEstimator`` (``learn/gan.py``) against the JAX
package's, on the CPU.

One adversarial step of each loss (``minimax``, ``lsgan``) from the same
parameters and JAX's own noise ``z`` (fed through the port's ``_step``
seam: the packages draw noise from different generators, ROADMAP C29):
D's and G's losses and every parameter of both networks after the step
within 1e-5 of JAX's (fp32; Adam's first step moves each parameter by
about the rate). The step order is JAX's: D on real and fake, then G
through the updated D. The three errors keep JAX's types; ``fit`` and
``generate`` run; without CUDA and without ``device="cpu"`` the
estimator raises. JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu_torch.learn.gan import GANEstimator

NOISE, BATCH = 4, 16


@pytest.fixture(scope="module")
def jg():
    pytest.importorskip("jax")
    import flax.linen as fnn
    import jax
    from analytics_zoo_tpu.learn.gan import GANEstimator as J

    class Gen(fnn.Module):
        @fnn.compact
        def __call__(self, z):
            h = fnn.relu(fnn.Dense(16)(z))
            return fnn.Dense(2)(h)

    class Disc(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            h = fnn.relu(fnn.Dense(16)(x))
            return fnn.Dense(1)(h)[:, 0]

    return dict(jax=jax, GAN=J, Gen=Gen, Disc=Disc)


class Disc(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(2, 16), nn.ReLU(),
                                 nn.Linear(16, 1))

    def forward(self, x):
        return self.net(x)[:, 0]


def _gen():
    return nn.Sequential(nn.Linear(NOISE, 16), nn.ReLU(), nn.Linear(16, 2))


def _load(seq, tree):
    """A flax Dense_0 / Dense_1 tree into the Linears of ``seq``."""
    linears = [m for m in seq.modules() if isinstance(m, nn.Linear)]
    with torch.no_grad():
        for i, lin in enumerate(linears):
            p = tree["params"][f"Dense_{i}"]
            lin.weight.copy_(torch.tensor(np.asarray(p["kernel"]).T))
            lin.bias.copy_(torch.tensor(np.asarray(p["bias"])))


def _tree(seq):
    linears = [m for m in seq.modules() if isinstance(m, nn.Linear)]
    return {f"Dense_{i}": {"kernel": lin.weight.detach().numpy().T,
                           "bias": lin.bias.detach().numpy()}
            for i, lin in enumerate(linears)}


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(64, 2) * 0.3 + [2.0, -1.0]).astype(np.float32)


@pytest.mark.parametrize("loss", ["minimax", "lsgan"])
def test_one_step_matches_jax_from_its_noise(jg, loss):
    jax = jg["jax"]
    x = _data()[:BATCH]
    j = jg["GAN"](jg["Gen"](), jg["Disc"](), noise_dim=NOISE, loss=loss,
                  seed=3)
    j._init_state(x)
    j._build_step()
    g0 = jax.device_get(j._state["g_params"])
    d0 = jax.device_get(j._state["d_params"])
    # JAX's noise for step 0 (learn/gan.py's step draws it so)
    z = jax.random.normal(jax.random.fold_in(
        jax.random.PRNGKey(j.seed + 101), 0), (BATCH, NOISE),
        dtype=np.float32)
    state, logs = j._step_fn(j._state, x)
    gen, disc = _gen(), Disc()
    _load(gen, g0)
    _load(disc, d0)
    t = GANEstimator(gen, disc, noise_dim=NOISE, loss=loss, seed=3,
                     device="cpu")
    d_loss, g_loss = t._step(torch.from_numpy(x),
                             torch.tensor(np.asarray(z)))
    np.testing.assert_allclose(float(d_loss), float(logs["d_loss"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(g_loss), float(logs["g_loss"]),
                               rtol=0, atol=1e-5)
    for got, want in ((_tree(gen), state["g_params"]["params"]),
                      (_tree(disc), state["d_params"]["params"])):
        want = jax.device_get(want)
        for layer in want:
            for leaf in ("kernel", "bias"):
                np.testing.assert_allclose(got[layer][leaf],
                                           np.asarray(want[layer][leaf]),
                                           rtol=0, atol=1e-5,
                                           err_msg=f"{layer}/{leaf}")


def test_the_three_errors_keep_jax_types(jg):
    ports = dict(device="cpu")
    for make, kw in ((lambda **k: GANEstimator(_gen(), Disc(), NOISE, **k),
                      ports),
                     (lambda **k: jg["GAN"](jg["Gen"](), jg["Disc"](),
                                            NOISE, **k), {})):
        with pytest.raises(ValueError, match="batch_size"):
            make(**kw).fit(np.zeros((8, 2), np.float32), batch_size=32)
        with pytest.raises(ValueError, match="minimax"):
            make(loss="wgan", **kw)
        with pytest.raises(RuntimeError, match="before generate"):
            make(**kw).generate(4)


@pytest.mark.parametrize("loss", ["minimax", "lsgan"])
def test_fit_and_generate(loss):
    torch.manual_seed(0)
    gan = GANEstimator(_gen(), Disc(), noise_dim=NOISE, loss=loss, seed=0,
                       device="cpu")
    hist = gan.fit(_data(), epochs=3, batch_size=BATCH)
    assert len(hist["d_loss"]) == len(hist["g_loss"]) == 3
    assert np.all(np.isfinite(hist["d_loss"] + hist["g_loss"]))
    assert gan._state["step"] == 3 * (64 // BATCH)
    out = gan.generate(10)
    assert out.shape == (10, 2) and np.all(np.isfinite(out))
    np.testing.assert_array_equal(gan.generate(10), out)      # seeded
    assert not np.array_equal(gan.generate(10, seed=1), out)


def test_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GANEstimator(_gen(), Disc(), noise_dim=NOISE)
