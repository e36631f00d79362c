"""GANEstimator (counterpart of analytics_zoo_tpu/orca/learn/gan.py;
reference: `pyzoo/zoo/tfpark/gan/gan_estimator.py`, TFGAN-style
alternating generator/discriminator training).

The generator G and the discriminator D are torch modules on one
device.  On each batch D takes `d_steps` steps, then G takes `g_steps`
against the updated D (gan.py:85-119), each sub-step on fresh noise
[batch, noise_dim]; `_step(real, d_noise, g_noise)` is that batch's
update, given the noise, and `fit` draws the noise from a
`torch.Generator` seeded `seed` on the modules' device, in the order the
sub-steps take it.  Only full batches train, in the order of
`np.random.default_rng(seed)`'s permutation.  The optimizers default to
`torch.optim.Adam(lr=1e-3, betas=(0.5, 0.999))`, optax's
`adam(1e-3, b1=0.5)`.  `save` / `load` write and read both modules'
state_dicts with `torch.save`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


def default_generator_loss(fake_logits):
    """Non-saturating G loss."""
    return _bce(fake_logits, 1.0)


def default_discriminator_loss(real_logits, fake_logits):
    """BCE with one-sided label smoothing on the real side."""
    return _bce(real_logits, 0.9) + _bce(fake_logits, 0.0)


def _optimizer(make: Optional[Callable], module: torch.nn.Module
               ) -> torch.optim.Optimizer:
    """`make(module.parameters())`, or Adam(1e-3, betas (0.5, 0.999))
    where `make` is None."""
    if make is None:
        return torch.optim.Adam(module.parameters(), lr=1e-3,
                                betas=(0.5, 0.999))
    return make(module.parameters())


class GANEstimator:
    """`generator` maps noise [b, noise_dim] to samples; `discriminator`
    maps samples to logits [b] (or [b, 1]); each optimizer is a function
    building a torch optimizer from a module's parameters (optax's
    transformations are not bound to parameters either).  `fit` on real
    samples; `generate` samples the trained generator."""

    def __init__(self, generator: torch.nn.Module,
                 discriminator: torch.nn.Module, *, noise_dim: int,
                 generator_loss_fn: Callable = default_generator_loss,
                 discriminator_loss_fn: Callable =
                 default_discriminator_loss,
                 generator_optimizer=None, discriminator_optimizer=None,
                 g_steps: int = 1, d_steps: int = 1, seed: int = 0):
        self.gen = generator
        self.disc = discriminator
        self.device = next(generator.parameters()).device
        self.noise_dim = noise_dim
        self.g_loss_fn = generator_loss_fn
        self.d_loss_fn = discriminator_loss_fn
        self.g_opt = _optimizer(generator_optimizer, generator)
        self.d_opt = _optimizer(discriminator_optimizer, discriminator)
        self.g_steps = int(g_steps)
        self.d_steps = int(d_steps)
        self.seed = seed
        self._noise = torch.Generator(device=self.device)
        self._noise.manual_seed(seed)
        self.train_summary: List[Dict[str, float]] = []

    def _disc_logits(self, x):
        out = self.disc(x)
        return out.reshape(out.shape[0])

    def _draw(self, n: int):
        return torch.randn((n, self.noise_dim), generator=self._noise,
                           device=self.device)

    def _step(self, real, d_noise: Sequence[torch.Tensor],
              g_noise: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One batch's update: a D step on each of `d_noise`, then a G
        step on each of `g_noise`; the last losses of each (0 where it
        took no step)."""
        d_params = list(self.disc.parameters())
        g_params = list(self.gen.parameters())
        d_loss = g_loss = real.new_zeros(())
        for z in d_noise:
            with torch.no_grad():
                fake = self.gen(z)
            d_loss = self.d_loss_fn(self._disc_logits(real),
                                    self._disc_logits(fake))
            for p, g in zip(d_params, torch.autograd.grad(d_loss, d_params)):
                p.grad = g
            self.d_opt.step()
        for z in g_noise:
            g_loss = self.g_loss_fn(self._disc_logits(self.gen(z)))
            for p, g in zip(g_params, torch.autograd.grad(g_loss, g_params)):
                p.grad = g
            self.g_opt.step()
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            shuffle: bool = True) -> "GANEstimator":
        """Trains on full batches only; each epoch's last batch's losses
        go to `train_summary`."""
        x = np.asarray(data["x"] if isinstance(data, dict) else data,
                       np.float32)
        if len(x) < batch_size:
            raise ValueError(
                f"dataset has {len(x)} samples but batch_size is "
                f"{batch_size}; no full batch to train on")
        rng = np.random.default_rng(self.seed)
        n = len(x)
        self.gen.train()
        self.disc.train()
        for _ in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            stats = None
            for s in range(0, n - batch_size + 1, batch_size):
                real = torch.from_numpy(x[order[s:s + batch_size]]).to(
                    self.device)
                d_noise = [self._draw(batch_size)
                           for _ in range(self.d_steps)]
                g_noise = [self._draw(batch_size)
                           for _ in range(self.g_steps)]
                stats = self._step(real, d_noise, g_noise)
            if stats is not None:
                self.train_summary.append(
                    {k: float(v) for k, v in stats.items()})
        return self

    @torch.no_grad()
    def generate(self, n: int, seed: Optional[int] = None) -> np.ndarray:
        """n samples of the generator from noise drawn by a generator
        seeded `seed` (None: the estimator's seed + 1)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1 if seed is None else seed)
        z = torch.randn((n, self.noise_dim), generator=gen,
                        device=self.device)
        self.gen.eval()
        return self.gen(z).float().cpu().numpy()

    @torch.no_grad()
    def discriminate(self, x: np.ndarray) -> np.ndarray:
        self.disc.eval()
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return self._disc_logits(x).float().cpu().numpy()

    def save(self, path: str) -> str:
        torch.save({"g": self.gen.state_dict(), "d": self.disc.state_dict()},
                   path)
        return path

    def load(self, path: str) -> "GANEstimator":
        saved = torch.load(path, map_location=self.device, weights_only=True)
        self.gen.load_state_dict(saved["g"])
        self.disc.load_state_dict(saved["d"])
        return self
