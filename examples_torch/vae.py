"""Variational autoencoder (mirrors ref apps/variational-autoencoder:
VAE built with the zoo Keras API).

The functional graph uses the ``GaussianSampler`` layer for the
reparameterized draw (ref torch.py GaussianSampler); the VAE objective
(reconstruction + KL) rides as a custom callable loss over the model's
packed [recon | mean | log_var] output — every piece trains through the
standard Estimator engine.

The counterpart of examples/vae.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/vae.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

LATENT = 2
D = 16


def make_data(n=512, seed=0):
    """Mixture of two gaussian blobs in 16-d."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(2, D).astype(np.float32)
    which = rng.randint(0, 2, n)
    x = centers[which] + 0.05 * rng.randn(n, D).astype(np.float32)
    return np.clip(x, 0, 1)


def vae_loss(y_true, y_pred):
    """y_pred = [recon(D) | mean(L) | log_var(L)]; per-sample ELBO loss."""
    import torch
    recon = y_pred[:, :D]
    mean = y_pred[:, D:D + LATENT]
    log_var = y_pred[:, D + LATENT:]
    rec = torch.square(recon - y_true).sum(-1)
    kl = -0.5 * torch.sum(
        1 + log_var - torch.square(mean) - torch.exp(log_var), dim=-1)
    return rec + 0.1 * kl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as zl
    from analytics_zoo_tpu_torch.learn.estimator import Estimator

    init_orca_context(cluster_mode="local", device=device)
    x = make_data()

    inp = Input(shape=(D,))
    h = zl.Dense(32, activation="relu")(inp)
    z_mean = zl.Dense(LATENT, name="z_mean")(h)
    z_log_var = zl.Dense(LATENT, name="z_log_var")(h)
    z = zl.GaussianSampler()([z_mean, z_log_var])
    dec = zl.Dense(32, activation="relu")(z)
    recon = zl.Dense(D, activation="sigmoid", name="recon")(dec)
    packed = zl.merge([recon, z_mean, z_log_var], mode="concat")
    vae = Model(input=inp, output=packed)

    est = Estimator.from_keras(keras_model=vae, loss=vae_loss,
                               optimizer="adam", device=device)
    hist = est.fit((x, x), epochs=20, batch_size=64)
    assert hist["loss"][-1] < hist["loss"][0], "VAE did not train"

    # eval-mode forward is deterministic (sampler returns the mean):
    # reconstruction should be close to the input
    out = np.asarray(est.predict(x, batch_size=64))
    rec_err = float(np.mean((out[:, :D] - x) ** 2))
    print(f"VAE: final loss {hist['loss'][-1]:.4f}, "
          f"recon mse {rec_err:.4f}")
    assert rec_err < 0.05, "reconstruction too lossy"
    stop_orca_context()


if __name__ == "__main__":
    main()
