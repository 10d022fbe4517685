"""GANEstimator — adversarial training of two ``nn.Module``s.

Counterpart of ``analytics_zoo_tpu/learn/gan.py`` (ref the TFGAN-style
estimator, pyzoo/zoo/tfpark/gan/gan_estimator.py:28: generator_fn /
discriminator_fn, separate G and D losses and optimizers, alternating
optimization). One step, in JAX's order:

1. draw the noise ``z``;
2. update D on the real batch and ``G(z)`` (G held fixed);
3. update G through the **updated** D;
4. G's loss is the non-saturating one (``-mean(log_sigmoid(D(G(z))))``),
   or least squares under ``loss="lsgan"``.

The optimizers are the port's (``learn/optimizers.py``: optax's update
rules). JAX draws ``z`` with threefry inside its jitted step; the port
draws it from a ``torch.Generator`` seeded by ``seed`` (ROADMAP C29), so
the two packages' noise differs: ``_step(x, z)`` takes a given ``z``,
which is how tests hold one step to JAX's. The modules train where
``device`` says (``cuda`` unless given; raises without CUDA).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device


class GANEstimator:
    def __init__(self, generator: torch.nn.Module,
                 discriminator: torch.nn.Module, noise_dim: int,
                 generator_optimizer="adam", discriminator_optimizer="adam",
                 loss: str = "minimax", seed: int = 0,
                 device: DeviceLike = None):
        from analytics_zoo_tpu_torch.learn.optimizers import Optimizer
        if loss not in ("minimax", "lsgan"):
            raise ValueError("loss must be 'minimax' or 'lsgan'")
        self.device = resolve_device(device)
        self.generator = generator.to(self.device)
        self.discriminator = discriminator.to(self.device)
        self.noise_dim = int(noise_dim)
        self.g_opt = Optimizer.get(generator_optimizer)
        self.d_opt = Optimizer.get(discriminator_optimizer)
        self.loss = loss
        self.seed = seed
        self._state = None
        self._noise = torch.Generator(device=self.device).manual_seed(
            seed + 101)

    # ------------------------------------------------------------- build
    def _init_state(self):
        """The optimizers' states (JAX's also initialises the parameters
        here, from a sample batch; the port's modules hold theirs
        already)."""
        if self._state is not None:
            return
        g = [p for p in self.generator.parameters()]
        d = [p for p in self.discriminator.parameters()]
        self._state = {"step": 0, "g_params": g, "d_params": d,
                       "g_opt": {"count": 0, **self.g_opt.init(g)},
                       "d_opt": {"count": 0, **self.d_opt.init(d)}}

    def _d_loss(self, real_logit, fake_logit):
        if self.loss == "lsgan":
            return (torch.mean((real_logit - 1.0) ** 2)
                    + torch.mean(fake_logit ** 2)) / 2
        return -(torch.mean(F.logsigmoid(real_logit))
                 + torch.mean(F.logsigmoid(-fake_logit)))

    def _g_loss(self, fake_logit):
        if self.loss == "lsgan":
            return torch.mean((fake_logit - 1.0) ** 2)
        return -torch.mean(F.logsigmoid(fake_logit))   # non-saturating

    @staticmethod
    def _update(opt, params, grads, state):
        with torch.no_grad():
            opt.step(params, list(grads), state, state["count"])
        state["count"] += 1

    def _step(self, x: torch.Tensor, z: torch.Tensor):
        """One adversarial step on the batch ``x`` with the noise ``z``
        (both on the device); returns (d_loss, g_loss) as 0-d tensors."""
        self._init_state()
        st = self._state
        gen, disc = self.generator, self.discriminator
        # D on real and fake, G held fixed
        with torch.no_grad():
            fake = gen(z)
        d_loss = self._d_loss(disc(x), disc(fake))
        d_grads = torch.autograd.grad(d_loss, st["d_params"])
        self._update(self.d_opt, st["d_params"], d_grads, st["d_opt"])
        # G through the updated D
        g_loss = self._g_loss(disc(gen(z)))
        g_grads = torch.autograd.grad(g_loss, st["g_params"])
        self._update(self.g_opt, st["g_params"], g_grads, st["g_opt"])
        st["step"] += 1
        return d_loss.detach(), g_loss.detach()

    def _draw(self, n: int, rng: torch.Generator) -> torch.Tensor:
        return torch.randn((n, self.noise_dim), generator=rng,
                           device=self.device, dtype=torch.float32)

    # ------------------------------------------------------------- api
    def fit(self, x, epochs: int = 1, batch_size: int = 32,
            shuffle: bool = True) -> Dict[str, list]:
        """(ref GANEstimator.train) Epochs over ``x`` in full batches;
        returns each epoch's mean D and G loss."""
        x = np.asarray(x, np.float32)
        if len(x) < batch_size:
            raise ValueError(
                f"dataset size {len(x)} < batch_size {batch_size}: no full "
                "batch can be formed (the trailing partial batch is always "
                "dropped to keep one shape)")
        self._init_state()
        data = torch.from_numpy(x).to(self.device)
        history = {"d_loss": [], "g_loss": []}
        rng = np.random.default_rng(self.seed)
        for _ in range(epochs):
            idx = rng.permutation(len(x)) if shuffle else np.arange(len(x))
            idx = torch.from_numpy(idx).to(self.device)
            d_losses, g_losses = [], []
            for lo in range(0, len(x) - batch_size + 1, batch_size):
                batch = data[idx[lo:lo + batch_size]]
                d, g = self._step(batch, self._draw(batch_size, self._noise))
                d_losses.append(d)
                g_losses.append(g)
            history["d_loss"].append(
                float(torch.stack(d_losses).cpu().numpy().mean()))
            history["g_loss"].append(
                float(torch.stack(g_losses).cpu().numpy().mean()))
        return history

    def generate(self, n: int, seed: Optional[int] = None) -> np.ndarray:
        """Sample n outputs from the generator (ref gan predict path)."""
        if self._state is None:
            raise RuntimeError("fit (or _init_state) before generate")
        rng = torch.Generator(device=self.device).manual_seed(
            self.seed + 7 if seed is None else seed)
        with torch.no_grad():
            out = self.generator(self._draw(n, rng))
        return out.float().cpu().numpy()
