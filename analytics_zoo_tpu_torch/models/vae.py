"""Variational autoencoder (counterpart of
analytics_zoo_tpu/models/vae.py:30-152; reference: the
variational-autoencoder app's notebook, a conv encoder -> (mu, log_var)
latent -> deconv decoder on MNIST-shaped images).  All f32.

`forward` returns (reconstruction_logits [b, H*W*C], kl [b]), the KL
term per example, and `estimator()` trains the ELBO through the engine's
aux loss: sigmoid-BCE reconstruction summed per example plus `beta` *
the KL term (`aux_loss_weight`), which the engine masked-means so the
padding of a ragged tail never biases it.  In training the
reparameterization noise comes from the `generator` the engine passes
(its dropout generator); in eval the latent is the posterior mean, so
`predict` is a deterministic encode-decode.

The layers are flax's, on NCHW tensors: the encoder's stride-2 3x3
convs pad "SAME" as XLA does (`layers.Conv`: 28 -> 14 pads (0, 1)); a
decoder layer is flax's `nn.ConvTranspose` (`ConvTranspose`), and the
decoder's output is cropped to the image (vae.py:103).  Modules are
named as the flax ones, so weights come from a flax tree through
`convert.vae_from_flax` (`image_from_flax`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    Conv,
    Dense,
    _lecun_normal_,
    to_nchw,
    to_nhwc,
)


def transpose_padding(kernel: int, stride: int) -> Tuple[int, int]:
    """lax.conv_transpose's "SAME" padding of one axis, over the input
    dilated by `stride` (jax `_conv_transpose_padding`): (low, high)."""
    pad_len = kernel + stride - 2
    low = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return low, pad_len - low


#: the kernel and stride of every VAE conv (flax `(3, 3)`, `(2, 2)`)
KERNEL, STRIDE = 3, 2


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose(out_ch, (3, 3), strides=(2, 2))`, f32:
    `lax.conv_transpose` with "SAME" padding and the kernel not flipped,
    i.e. a convolution of the input dilated by 2, padded (low, high) =
    `transpose_padding(3, 2)` = (2, 1).  The weight is laid out as a
    Conv's (out, in, kh, kw), the flax kernel unflipped.  torch's
    `conv_transpose2d` convolves the dilated input with the flipped
    kernel, in and out swapped, padded k - 1 - p on each side: given
    that kernel with p = k - 1 - low it pads `low` on both sides, and
    the output's last `low - high` rows and columns (which only the
    extra padding reaches) are cropped."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, KERNEL, KERNEL,
                                               device=device))
        _lecun_normal_(self.weight, in_ch * KERNEL * KERNEL)
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x):
        low, high = transpose_padding(KERNEL, STRIDE)
        w = self.weight.transpose(0, 1).flip(2, 3)
        y = F.conv_transpose2d(x, w, self.bias, STRIDE, KERNEL - 1 - low)
        cut = low - high
        return y[:, :, :y.shape[2] - cut, :y.shape[3] - cut]


class _Decoder(nn.Module):
    """`VAE.decode` as a module's forward (for `functional_call`)."""

    def __init__(self, vae):
        super().__init__()
        self.vae = vae

    def forward(self, z):
        return self.vae.decode(z)


class VAE(ZooModel, nn.Module):
    """Conv VAE over [b, H, W, C] images in [0, 1]: -> (reconstruction
    logits [b, H*W*C], kl [b])."""

    def __init__(self, latent_dim: int = 2,
                 image_shape: Tuple[int, int, int] = (28, 28, 1),
                 enc_features: Sequence[int] = (32, 64), beta: float = 1.0,
                 device=None):
        nn.Module.__init__(self)
        self._config = dict(latent_dim=latent_dim,
                            image_shape=tuple(image_shape),
                            enc_features=tuple(enc_features), beta=beta)
        self.device_ = dev = resolve_device(device)
        self.latent_dim = latent_dim
        self.image_shape = tuple(image_shape)
        self.enc_features = tuple(enc_features)
        self.beta = beta
        h, w, c = self.image_shape
        self._enc = []
        fan_in = c
        for f in self.enc_features:
            self._enc.append(f"enc_conv{f}")
            self.add_module(self._enc[-1], Conv(
                fan_in, f, KERNEL, STRIDE, "SAME", dtype=torch.float32,
                device=dev))
            fan_in = f
        hh, ww = h, w
        for _ in self.enc_features:
            hh, ww = -(-hh // 2), -(-ww // 2)
        self._grid = (hh, ww)
        flat = hh * ww * self.enc_features[-1]
        self.mu = Dense(flat, latent_dim, device=dev)
        self.log_var = Dense(flat, latent_dim, device=dev)
        self.dec_in = Dense(latent_dim, flat, device=dev)
        self._dec = []
        fan_in = self.enc_features[-1]
        for f in reversed(self.enc_features[:-1]):
            self._dec.append(f"dec_deconv{f}")
            self.add_module(self._dec[-1],
                            ConvTranspose(fan_in, f, device=dev))
            fan_in = f
        self.dec_out = ConvTranspose(fan_in, c, device=dev)

    def flax_layout(self):
        """(to_flax(state_dict), from_flax(tree)): the JAX module's
        param tree (`convert.vae_to_flax` and `vae_from_flax`)."""
        from analytics_zoo_tpu_torch import convert
        return convert.vae_to_flax, convert.vae_from_flax

    def forward(self, x, generator=None):
        b = x.shape[0]
        h, w, c = self.image_shape
        y = to_nchw(x.reshape(b, h, w, c).float())
        for name in self._enc:
            y = F.relu(getattr(self, name)(y))
        y = to_nhwc(y).reshape(b, -1)
        mu, log_var = self.mu(y), self.log_var(y)
        if self.training:
            if generator is None:
                raise ValueError("VAE training needs a generator for the "
                                 "reparameterization noise")
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device)
            z = mu + torch.exp(0.5 * log_var) * eps
        else:
            z = mu                      # posterior mean: deterministic eval
        # KL(q(z|x) || N(0, I)) per example, summed over latent dims
        kl = 0.5 * torch.sum(torch.exp(log_var) + mu ** 2 - 1.0 - log_var,
                             dim=-1)
        return self.decode(z), kl

    def decode(self, z):
        """Latents [b, latent_dim] -> reconstruction logits [b, H*W*C];
        the loss applies the sigmoid."""
        b = z.shape[0]
        h, w, c = self.image_shape
        hh, ww = self._grid
        y = F.relu(self.dec_in(z)).reshape(b, hh, ww, self.enc_features[-1])
        y = to_nchw(y)
        for name in self._dec:
            y = F.relu(getattr(self, name)(y))
        y = to_nhwc(self.dec_out(y))
        # transposed convs can overshoot the target size on odd inputs
        return y[:, :h, :w, :].reshape(b, h * w * c)

    def recon_bce(self, logits, labels):
        """Per-example summed sigmoid BCE between reconstruction logits
        and the flattened images: JAX's `max(l, 0) - l t + log1p(exp(
        -|l|))`, whose gradient torch's fused form gives as sigmoid(l) -
        t everywhere (autograd through JAX's three terms is off by 0.5
        at a logit of exactly 0, where max and abs have their kinks)."""
        h, w, c = self.image_shape
        if isinstance(labels, (tuple, list)):
            labels = labels[0]
        target = labels.reshape(labels.shape[0], h * w * c)
        return F.binary_cross_entropy_with_logits(
            logits, target, reduction="none").sum(dim=-1)

    # -- ZooModel integration -------------------------------------------

    def estimator(self, **kwargs):
        """An Estimator wired for the ELBO: `recon_bce` plus beta * KL
        through `aux_loss_weight`, Adam 1e-3, no metrics (each a default
        the keywords may override)."""
        from analytics_zoo_tpu_torch.orca.learn.estimator import Estimator
        kwargs.setdefault("loss", self.recon_bce)
        kwargs.setdefault("metrics", [])
        kwargs.setdefault("aux_loss_weight", float(self.beta))
        kwargs.setdefault("learning_rate", 1e-3)
        kwargs.setdefault("optimizer", "adam")
        self._estimator = Estimator.from_torch(self, **kwargs)
        return self._estimator

    # -- generation ------------------------------------------------------

    @torch.no_grad()
    def generate(self, n: int = 16, seed: int = 0,
                 params=None) -> np.ndarray:
        """Decode n latent draws from the N(0, I) prior (a
        `torch.Generator` seeded `seed` on the model's device) into
        images [n, H, W, C] in [0, 1], with the model's weights or the
        state_dict `params`."""
        gen = torch.Generator(device=self.device_)
        gen.manual_seed(seed)
        z = torch.randn((n, self.latent_dim), generator=gen,
                        device=self.device_)
        if params is None:
            logits = self.decode(z)
        else:
            logits = torch.func.functional_call(
                _Decoder(self), {f"vae.{k}": v for k, v in params.items()},
                (z,))
        h, w, c = self.image_shape
        return torch.sigmoid(logits).cpu().numpy().reshape(n, h, w, c)

    def reconstruct(self, images: np.ndarray) -> np.ndarray:
        """Deterministic encode-decode (posterior mean) in [0, 1]."""
        est = self._require_estimator()
        logits = est.predict({"x": np.asarray(images, np.float32)})
        h, w, c = self.image_shape
        return torch.sigmoid(torch.from_numpy(logits)).numpy().reshape(
            len(images), h, w, c)
