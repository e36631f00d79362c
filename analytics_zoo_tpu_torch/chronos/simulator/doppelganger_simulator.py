"""DoppelGANger-style time-series simulator (counterpart of
analytics_zoo_tpu/chronos/simulator/doppelganger_simulator.py): a GAN
over (attributes, measurement sequence) pairs (Lin et al., "Using GANs
for Sharing Networked Time Series Data").

Three torch modules: the attribute generator (an MLP from noise,
sigmoid out), the sequence generator (a GRU, `recurrent.gru`, over
noise and the attributes repeated at every step, a sigmoid Dense out)
and the discriminator (an MLP over the attributes and the flattened
sequence, one logit).  Features and attributes are scaled min-max to
[0, 1]; `attr_dim = 0` means an attribute width of 1 (zeros).

One adversarial step (`gan_step`) keeps JAX's jitted step's semantics:
the D step and the G step use the SAME noise; D's loss is BCE with
logits, the real side smoothed to 0.9; D is updated first, and the
non-saturating G loss is taken against D's updated parameters; two
Adams with b1 = 0.5.  The step takes its noise as arguments, so a test
can feed it JAX's; `fit` draws it from an explicit `torch.Generator`
on the device, seeded from `seed`.  A batch under 2 rows is skipped,
and the losses are read to the host once an epoch.  `device` (None:
the CUDA card, or a raise) is where the networks train.  `generate`,
`save` / `load` (a pickle of the generator's torch-layout numpy
state_dict), and `convert.dpgan_generator_from_flax` /
`dpgan_discriminator_from_flax` for JAX's trees.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.common import recurrent
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Dense,
)


def _mlp(widths, device) -> nn.ModuleList:
    return nn.ModuleList(Dense(a, b, device=device)
                         for a, b in zip(widths, widths[1:]))


class _AttrGenerator(nn.Module):
    def __init__(self, noise_dim: int, attr_dim: int, hidden: int, device):
        super().__init__()
        self.layers = _mlp([noise_dim, hidden, hidden, attr_dim], device)

    def forward(self, z):
        h = torch.relu(self.layers[0](z))
        h = torch.relu(self.layers[1](h))
        return torch.sigmoid(self.layers[2](h))


class _SeqGenerator(nn.Module):
    def __init__(self, noise_dim: int, attr_dim: int, feature_dim: int,
                 hidden: int, device):
        super().__init__()
        self.gru = recurrent.gru(noise_dim + attr_dim, hidden, device)
        self.out = Dense(hidden, feature_dim, device=device)

    def forward(self, z_seq, attrs):
        """z_seq [b, T, noise], attrs [b, A] -> [b, T, F] in [0, 1]."""
        cond = attrs[:, None, :].expand(-1, z_seq.shape[1], -1)
        hs = self.gru(torch.cat([z_seq, cond], dim=-1))[0]
        return torch.sigmoid(self.out(hs))


class _Generator(nn.Module):
    """(noise for the attributes, noise for the sequence) -> (attrs,
    seq)."""

    def __init__(self, noise_dim: int, attr_dim: int, feature_dim: int,
                 hidden: int, device):
        super().__init__()
        self.attr = _AttrGenerator(noise_dim, attr_dim, hidden, device)
        self.seq = _SeqGenerator(noise_dim, attr_dim, feature_dim, hidden,
                                 device)

    def forward(self, z_a, z_s):
        attrs = self.attr(z_a)
        return attrs, self.seq(z_s, attrs)


class _Discriminator(nn.Module):
    def __init__(self, attr_dim: int, seq_len: int, feature_dim: int,
                 hidden: int, device):
        super().__init__()
        self.layers = _mlp([attr_dim + seq_len * feature_dim, hidden,
                            hidden, 1], device)

    def forward(self, attrs, seq):
        h = torch.cat([attrs, seq.reshape(seq.shape[0], -1)], dim=-1)
        h = torch.relu(self.layers[0](h))
        h = torch.relu(self.layers[1](h))
        return self.layers[2](h)[:, 0]


def _bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


class DPGANSimulator:
    """fit(features [n, T, F], attributes [n, A]), then generate(n) ->
    (attributes, features) with the training data's scale restored.
    JAX's constructor, and `device`."""

    def __init__(self, seq_len: int, feature_dim: int, attr_dim: int = 0,
                 noise_dim: int = 8, hidden: int = 64, lr: float = 1e-3,
                 seed: int = 0, device=None):
        self.seq_len = seq_len
        self.feature_dim = feature_dim
        self.attr_dim = attr_dim
        self.noise_dim = noise_dim
        self.hidden = hidden
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        self.generator = None         # the _Generator, once fit or loaded
        self.discriminator = None
        self.loss_history = []

    # -- models ---------------------------------------------------------

    def _build(self):
        """The generator and discriminator drawn from `seed`, and their
        Adams."""
        a = max(self.attr_dim, 1)
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(self.seed)
            self.generator = _Generator(self.noise_dim, a, self.feature_dim,
                                        self.hidden, self.device)
            self.discriminator = _Discriminator(a, self.seq_len,
                                                self.feature_dim,
                                                self.hidden, self.device)
        self.g_opt = torch.optim.Adam(self.generator.parameters(),
                                      lr=self.lr, betas=(0.5, 0.999))
        self.d_opt = torch.optim.Adam(self.discriminator.parameters(),
                                      lr=self.lr, betas=(0.5, 0.999))

    def noise(self, n: int, generator: torch.Generator):
        """(z_a [n, noise], z_s [n, T, noise]) from `generator`."""
        z_a = torch.randn(n, self.noise_dim, generator=generator,
                          device=self.device)
        z_s = torch.randn(n, self.seq_len, self.noise_dim,
                          generator=generator, device=self.device)
        return z_a, z_s

    # -- training -------------------------------------------------------

    def gan_step(self, real_attrs, real_seq, z_a, z_s
                 ) -> Dict[str, torch.Tensor]:
        """One adversarial step on a real batch and one draw of noise:
        D's update, then G's against the updated D.  The losses stay on
        the device."""
        g_params = list(self.generator.parameters())
        d_params = list(self.discriminator.parameters())
        fake_a, fake_s = self.generator(z_a, z_s)
        d_loss = (_bce(self.discriminator(real_attrs, real_seq), 0.9)
                  + _bce(self.discriminator(fake_a.detach(),
                                            fake_s.detach()), 0.0))
        for p, g in zip(d_params, torch.autograd.grad(d_loss, d_params)):
            p.grad = g
        self.d_opt.step()
        # the G loss against D's updated parameters, on the same fakes
        g_loss = _bce(self.discriminator(fake_a, fake_s), 1.0)
        for p, g in zip(g_params, torch.autograd.grad(g_loss, g_params)):
            p.grad = g
        self.g_opt.step()
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}

    def _scale_fit(self, feats: np.ndarray, attrs: np.ndarray):
        """Min-max statistics of the data, and the data in [0, 1]."""
        self._f_min = feats.min(axis=(0, 1))
        self._f_max = feats.max(axis=(0, 1))
        span = np.where(self._f_max > self._f_min,
                        self._f_max - self._f_min, 1.0)
        self._a_min = attrs.min(axis=0)
        self._a_max = attrs.max(axis=0)
        a_span = np.where(self._a_max > self._a_min,
                          self._a_max - self._a_min, 1.0)
        return ((feats - self._f_min) / span).astype(np.float32), \
            ((attrs - self._a_min) / a_span).astype(np.float32)

    def fit(self, features: np.ndarray,
            attributes: Optional[np.ndarray] = None,
            epochs: int = 50, batch_size: int = 32):
        feats = np.asarray(features, np.float32)
        n = feats.shape[0]
        if feats.shape[1:] != (self.seq_len, self.feature_dim):
            raise ValueError(
                f"features must be [n, {self.seq_len}, "
                f"{self.feature_dim}], got {feats.shape}")
        attrs = (np.asarray(attributes, np.float32)
                 if attributes is not None
                 else np.zeros((n, 1), np.float32))
        feats01, attrs01 = self._scale_fit(feats, attrs)
        self._build()
        real_s = torch.from_numpy(feats01).to(self.device)
        real_a = torch.from_numpy(attrs01).to(self.device)
        noise_gen = torch.Generator(device=self.device)
        noise_gen.manual_seed(self.seed)
        rng = np.random.default_rng(self.seed)
        for _ in range(epochs):
            # one upload of the epoch's order; the batches are sliced
            # on the device
            order = torch.from_numpy(rng.permutation(n)).to(self.device)
            stats = None
            for s in range(0, n, batch_size):
                take = order[s:s + batch_size]
                if len(take) < 2:
                    continue
                z_a, z_s = self.noise(len(take), noise_gen)
                stats = self.gan_step(real_a[take], real_s[take], z_a, z_s)
            if stats is not None:
                d, g = torch.stack([stats["d_loss"],
                                    stats["g_loss"]]).tolist()
                self.loss_history.append({"d_loss": d, "g_loss": g})
        return self

    # -- generation -----------------------------------------------------

    @torch.no_grad()
    def generate(self, sample_num: int, seed: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """`sample_num` (attributes, features) in the data's units, from
        noise drawn with `seed` (default: the simulator's seed + 1)."""
        if self.generator is None:
            raise RuntimeError("call fit first")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1 if seed is None else seed)
        attrs01, feats01 = self.generator(*self.noise(sample_num, gen))
        attrs01, feats01 = attrs01.cpu().numpy(), feats01.cpu().numpy()
        feats = feats01 * np.where(self._f_max > self._f_min,
                                   self._f_max - self._f_min, 1.0) \
            + self._f_min
        attrs = attrs01 * np.where(self._a_max > self._a_min,
                                   self._a_max - self._a_min, 1.0) \
            + self._a_min
        return attrs, feats

    # -- persistence ----------------------------------------------------

    def _config(self):
        return dict(seq_len=self.seq_len, feature_dim=self.feature_dim,
                    attr_dim=self.attr_dim, noise_dim=self.noise_dim,
                    hidden=self.hidden, lr=self.lr, seed=self.seed)

    def save(self, path: str):
        fitted = self.generator is not None
        payload = {
            "config": self._config(),
            "g": ({k: v.detach().cpu().numpy() for k, v in
                   self.generator.state_dict().items()}
                  if fitted else None),
            "scales": (self._f_min, self._f_max, self._a_min,
                       self._a_max) if fitted else None,
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        return path

    @classmethod
    def load(cls, path: str, device=None):
        """The simulator saved at `path`, on `device` (None: the CUDA
        card)."""
        with open(path, "rb") as f:
            d = pickle.load(f)
        self = cls(**d["config"], device=device)
        if d["g"] is not None:
            self._build()
            self.generator.load_state_dict(
                {k: torch.from_numpy(v) for k, v in d["g"].items()})
            (self._f_min, self._f_max,
             self._a_min, self._a_max) = d["scales"]
        return self
