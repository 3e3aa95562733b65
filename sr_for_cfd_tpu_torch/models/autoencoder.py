"""Convolutional super-resolution autoencoder family as `nn.Module`s
(counterpart of `sr_for_cfd_tpu/models/autoencoder.py`).

The architectures come from the same ENCODER_SPECS / DECODER_SPECS tables.
Inputs and outputs keep the JAX package's NHWC layout, (N, res, res, 1);
inside, the modules work in PyTorch's NCHW. Padding follows Flax/Keras:

* "SAME" convolutions pad (total // 2, total - total // 2), so a stride-2
  conv pads at the end; an explicit `F.pad` does that.
* Transposed convolutions: Flax's `nn.ConvTranspose` (transpose_kernel =
  False) pads the dilated input by `_conv_transpose_padding(k, s, mode)`
  of `jax.lax.conv_transpose`; this module computes the full transposed
  convolution and crops it to that padding. Kernels carried over from Flax
  are flipped spatially (see `io/checkpoint.params_from_jax`).

swish == silu. Latent dim 50 by default.

`flax_init_` initialises a module as Flax's `init` does by default:
every Conv, ConvTranspose and Dense kernel from `lecun_normal` (a normal
truncated at two standard deviations, scaled to variance 1/fan_in, fan_in
= kernel height x width x input channels, or the input features), every
bias zero. The draws come from an explicit `torch.Generator`, so they are
not JAX's numbers; the distribution is. PyTorch's own default
(kaiming-uniform weights and biases) would train to another result.
"""

from __future__ import annotations

import math
from typing import Mapping, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

LATENT_DIM = 50

# (filters, kernel, stride) conv ladder per input resolution
ENCODER_SPECS = {
    10: ((64, 3, 2), (128, 3, 1)),
    20: ((64, 3, 2), (128, 3, 2)),
    50: ((64, 3, 2), (128, 3, 2), (256, 3, 2), (512, 3, 2)),
    80: ((32, 3, 2), (64, 3, 2), (128, 3, 2), (256, 3, 2)),
    100: ((32, 3, 2), (64, 3, 2), (128, 3, 2), (256, 3, 2), (512, 3, 2)),
    400: ((16, 3, 2), (32, 3, 2), (64, 3, 2), (128, 3, 2), (256, 3, 2)),
}

# (reshape HWC, ((filters, kernel, stride, padding), ...)) per output res
DECODER_SPECS = {
    10: ((5, 5, 128), ((64, 3, 2, "SAME"),)),
    20: ((5, 5, 128), ((64, 3, 2, "SAME"), (32, 3, 2, "SAME"))),
    50: ((3, 3, 512), ((256, 3, 2, "SAME"), (128, 3, 2, "SAME"),
                       (64, 3, 2, "VALID"), (32, 2, 2, "VALID"))),
    80: ((5, 5, 256), ((128, 3, 2, "SAME"), (64, 3, 2, "SAME"),
                       (32, 3, 2, "SAME"), (16, 3, 2, "SAME"))),
    100: ((3, 3, 512), ((256, 3, 2, "SAME"), (128, 3, 2, "SAME"),
                        (64, 3, 2, "VALID"), (32, 2, 2, "VALID"),
                        (16, 2, 2, "VALID"))),
    400: ((12, 12, 256), ((128, 3, 2, "VALID"), (64, 2, 2, "VALID"),
                          (32, 2, 2, "VALID"), (16, 2, 2, "VALID"),
                          (8, 2, 2, "VALID"))),
}

RESOLUTIONS = tuple(sorted(ENCODER_SPECS))


def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of a "SAME" convolution along one axis."""
    out = math.ceil(n / s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_transpose_pad(k: int, s: int, padding: str) -> Tuple[int, int]:
    """`jax.lax.conv_transpose`'s padding of the dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"unknown padding {padding!r}")
    return pad_a, pad_len - pad_a


class SameConv2d(nn.Conv2d):
    """Conv2d with Flax/Keras "SAME" padding (asymmetric when strided)."""

    def __init__(self, cin, cout, k, s):
        super().__init__(cin, cout, k, stride=s, padding=0)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        ph = same_pad(x.shape[2], k, s)
        pw = same_pad(x.shape[3], k, s)
        return super().forward(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


class FlaxConvTranspose2d(nn.ConvTranspose2d):
    """Flax `nn.ConvTranspose` semantics on top of PyTorch's (which is the
    full transposed convolution here, then cropped to Flax's padding)."""

    def __init__(self, cin, cout, k, s, padding):
        super().__init__(cin, cout, k, stride=s, padding=0)
        pad_a, pad_b = conv_transpose_pad(k, s, padding)
        self.crop = (k - 1 - pad_a, k - 1 - pad_b)
        if min(self.crop) < 0:
            raise ValueError("padding wider than the full transposed conv")

    def forward(self, x):
        y = super().forward(x)
        a, b = self.crop
        return y[:, :, a:y.shape[2] - b, a:y.shape[3] - b]


class Encoder(nn.Module):
    """Conv ladder -> Flatten -> Dense(128, swish) -> Dense(latent)."""

    def __init__(self, resolution: int, latent_dim: int = LATENT_DIM):
        super().__init__()
        if resolution not in ENCODER_SPECS:
            raise ValueError(f"No encoder spec for resolution {resolution}; "
                             f"available: {RESOLUTIONS}")
        convs, cin, n = [], 1, resolution
        for filters, kernel, stride in ENCODER_SPECS[resolution]:
            convs.append(SameConv2d(cin, filters, kernel, stride))
            cin, n = filters, math.ceil(n / stride)
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(cin * n * n, 128)
        self.latent_vector = nn.Linear(128, latent_dim)

    def forward(self, x):  # (N, C, H, W)
        for conv in self.convs:
            x = F.silu(conv(x))
        x = F.silu(self.dense(x.flatten(1)))
        return self.latent_vector(x)


class Decoder(nn.Module):
    """Dense -> reshape -> ConvTranspose ladder (swish) -> Conv(1, 3, SAME)."""

    def __init__(self, resolution: int, latent_dim: int = LATENT_DIM):
        super().__init__()
        if resolution not in DECODER_SPECS:
            raise ValueError(f"No decoder spec for resolution {resolution}; "
                             f"available: {RESOLUTIONS}")
        (h, w, c), ladder = DECODER_SPECS[resolution]
        self.hwc = (h, w, c)
        self.dense = nn.Linear(latent_dim, h * w * c)
        layers, cin = [], c
        for filters, kernel, stride, padding in ladder:
            layers.append(FlaxConvTranspose2d(cin, filters, kernel, stride,
                                              padding))
            cin = filters
        self.deconvs = nn.ModuleList(layers)
        self.output_conv = SameConv2d(cin, 1, 3, 1)

    def forward(self, z):
        h, w, c = self.hwc
        x = F.silu(self.dense(z)).reshape(z.shape[0], c, h, w)
        for layer in self.deconvs:
            x = F.silu(layer(x))
        return self.output_conv(x)


class SuperResolutionAE(nn.Module):
    """decoder_hr(encoder_lr(x)) on NHWC batches (N, lr, lr, 1) ->
    (N, hr, hr, 1)."""

    def __init__(self, lr_resolution: int, hr_resolution: int,
                 latent_dim: int = LATENT_DIM):
        super().__init__()
        self.lr_resolution, self.hr_resolution = lr_resolution, hr_resolution
        self.encoder_lr = Encoder(lr_resolution, latent_dim)
        self.decoder_hr = Decoder(hr_resolution, latent_dim)

    def forward(self, x):
        return self.decode(self.encode(x))

    def encode(self, x):
        """(N, lr, lr, 1) NHWC -> (N, latent)."""
        return self.encoder_lr(x.permute(0, 3, 1, 2))

    def decode(self, z):
        """(N, latent) -> (N, hr, hr, 1) NHWC."""
        return self.decoder_hr(z).permute(0, 2, 3, 1)


# jax.nn.initializers.variance_scaling: the standard deviation of a
# standard normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every convolution, transposed convolution and linear
    layer of `module` in place as Flax's defaults do (lecun_normal kernels,
    zero biases), drawing from `generator`; returns the module."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
                fan_in = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
            elif isinstance(m, nn.Conv2d):  # (out, in, kh, kw)
                fan_in = m.weight[0].numel()
            elif isinstance(m, nn.Linear):  # (out, in)
                fan_in = m.weight.shape[1]
            else:
                continue
            nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
            m.weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNCATED_STD)
            nn.init.zeros_(m.bias)
    return module


def build_encoder(resolution: int, latent_dim: int = LATENT_DIM) -> Encoder:
    return Encoder(resolution, latent_dim)


def build_decoder(resolution: int, latent_dim: int = LATENT_DIM) -> Decoder:
    return Decoder(resolution, latent_dim)


def param_count(params: Union[nn.Module, Mapping]) -> int:
    """Number of parameters of a module, a state_dict or a (nested) Flax
    parameter tree."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    total = 0
    for leaf in params.values():
        total += param_count(leaf) if isinstance(leaf, Mapping) else int(math.prod(leaf.shape))
    return total
