"""ML super-resolution inference: coarse -> fine field upsampling
(counterpart of `sr_for_cfd_tpu/sr/inference.py`).

Per component: (optional rect -> square resample) -> standardize ->
encoder/decoder -> inverse-standardize -> (resample to the requested fine
shape) -> NaN/Inf scrub. The three components run as one batch of 3.

`resize_cubic` is the operator of `jax.image.resize(method='cubic')`:
Keys' cubic kernel with a = -0.5 and antialiasing, applied as one weight
matrix per resized axis. It is not `F.interpolate(mode='bicubic')`, whose
kernel has a = -0.75.

TF32 is off on the SR path: cuDNN's convolutions default to TF32
(`torch.backends.cudnn.allow_tf32 = True`), which keeps about three decimal
digits, so `SRModel.predict` sets it False and keeps
`torch.backends.cuda.matmul.allow_tf32` False for its forward pass, and
restores the caller's settings after it. The AE's convolutions go to
cuDNN; in the JAX package XLA, not Pallas, computes them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..models.autoencoder import LATENT_DIM, SuperResolutionAE, flax_init_
from ..models.standardize import (
    COMPONENTS,
    STD_FLOOR,
    component_stats,
    read_stats_file,
)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def cubic_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 matrix of `jax.image.resize(..., 'cubic')`
    along one axis (`jax._src.image.scale.compute_weight_mat`)."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1.0), 0.0)
    valid = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.ascontiguousarray(np.where(valid[None, :], w, 0.0).T)


def resize_cubic(field: torch.Tensor, shape) -> torch.Tensor:
    """`jax.image.resize(field, shape, 'cubic')`: every axis whose size
    changes is resampled by its weight matrix."""
    out = field
    for d, (n_in, n_out) in enumerate(zip(field.shape, shape)):
        if n_in == n_out:
            continue
        w = torch.as_tensor(cubic_weight_matrix(n_in, n_out),
                            dtype=field.dtype, device=field.device)
        out = torch.movedim(torch.tensordot(w, out, dims=([1], [d])), 0, d)
    return out


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for cuDNN and matmuls inside the block only."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class SRModel:
    """A `SuperResolutionAE` with its weights: (N, lr, lr, 1) -> (N, hr, hr, 1)."""

    def __init__(self, lr_dim: int, hr_dim: int, module: torch.nn.Module):
        self.lr_dim, self.hr_dim = lr_dim, hr_dim
        self.module = module

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The module's weights (its `state_dict`)."""
        return self.module.state_dict()

    @classmethod
    def create(cls, lr_dim: int, hr_dim: int, params: Optional[Dict] = None,
               latent_dim: int = LATENT_DIM, rng_seed: int = 0,
               device="cuda") -> "SRModel":
        """A model with `params` (a `state_dict`, or a Flax parameter tree
        as `params_from_jax` takes it), else freshly initialised as Flax
        initialises it, drawn from a generator seeded with `rng_seed`."""
        from ..io.checkpoint import params_from_jax
        from ..utils.device import resolve_device

        module = SuperResolutionAE(lr_dim, hr_dim, latent_dim)
        if params is None:
            flax_init_(module, torch.Generator().manual_seed(rng_seed))
        else:
            tree = params.get("params", params)
            if "encoder_lr" in tree:
                params = params_from_jax(params, lr_dim, hr_dim)
            module.load_state_dict(params)
        return cls(lr_dim, hr_dim, module.to(resolve_device(device)).eval())

    @classmethod
    def from_checkpoint(cls, path: str, lr_dim: int, hr_dim: int,
                        device="cuda") -> "SRModel":
        """Load a Flax msgpack checkpoint (`io/checkpoint.py`)."""
        from ..io.checkpoint import load_sr_model

        return cls(lr_dim, hr_dim, load_sr_model(path, lr_dim, hr_dim, device))

    @classmethod
    def from_parts(cls, encoder_file: str, decoder_file: str, lr_dim: int,
                   hr_dim: int, latent_dim: int = LATENT_DIM,
                   device="cuda") -> "SRModel":
        """Assemble from split encoder/decoder checkpoints, the reference's
        convention (`PyCFD_ML_accelerated.py:831-833`): .msgpack parts are
        Flax msgpack files (`io/checkpoint.py`), .h5 parts Keras checkpoints
        (`models/keras_import.py`, which needs h5py)."""
        from ..io.checkpoint import load_params, params_to_jax
        from ..models import keras_import

        template = params_to_jax(SuperResolutionAE(lr_dim, hr_dim, latent_dim)
                                 .state_dict(), lr_dim, hr_dim)["params"]
        parts = {}
        for key, path, load_h5 in (
                ("encoder_lr", encoder_file, keras_import.load_keras_encoder_params),
                ("decoder_hr", decoder_file, keras_import.load_keras_decoder_params)):
            tree = (load_h5(path) if path.endswith(".h5")
                    else load_params(path, {"params": template[key]}))
            parts[key] = tree["params"]
        return cls.create(lr_dim, hr_dim, {"params": parts}, latent_dim,
                          device=device)

    @classmethod
    def from_combined_h5(cls, path: str, lr_dim: int, hr_dim: int,
                         latent_dim: int = LATENT_DIM, device="cuda") -> "SRModel":
        """Load a combined `superresolution{lr}to{hr}_*.h5` artifact (the
        reference's third export, `sr-ae-conv.ipynb` export cell; needs
        h5py)."""
        from ..models.keras_import import load_keras_combined_params

        return cls.create(lr_dim, hr_dim, load_keras_combined_params(path),
                          latent_dim, device=device)

    @torch.no_grad()
    def predict(self, x: torch.Tensor) -> torch.Tensor:
        with _no_tf32():
            return self.module(x)


class BicubicSR:
    """Weightless fallback: cubic upsample LR -> HR in standardized space."""

    def __init__(self, lr_dim: int, hr_dim: int):
        self.lr_dim, self.hr_dim = lr_dim, hr_dim

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return resize_cubic(x, (x.shape[0], self.hr_dim, self.hr_dim, 1))


def _sr_core(x, mean_lr, std_lr, mean_hr, std_hr, model, lr_dim, out_shape,
             aspect_correct: bool, blend_factor: float, adaptive: bool):
    """The SR pipeline on (3, src_ny, src_nx) raw fields; returns
    (3, out_ny, out_nx)."""
    if aspect_correct:
        x = resize_cubic(x, (3, lr_dim, lr_dim))
    if adaptive:
        in_mean = torch.mean(x, dim=(1, 2))
        in_std = torch.std(x, dim=(1, 2), correction=0)
        mean_lr = (1 - blend_factor) * mean_lr + blend_factor * in_mean
        std_lr = (1 - blend_factor) * std_lr + blend_factor * torch.clamp(
            in_std, min=STD_FLOOR)
    std_lr = torch.clamp(torch.abs(std_lr), min=STD_FLOOR)
    std_hr = torch.clamp(torch.abs(std_hr), min=STD_FLOOR)
    x_norm = (x - mean_lr[:, None, None]) / std_lr[:, None, None]
    pred = model.predict(x_norm[..., None])[..., 0]
    pred = pred * std_hr[:, None, None] + mean_hr[:, None, None]
    if tuple(pred.shape[1:]) != tuple(out_shape):
        pred = resize_cubic(pred, (3,) + tuple(out_shape))
    return torch.nan_to_num(pred, nan=0.0, posinf=0.0, neginf=0.0)


def ml_super_resolution(
    coarse_fields: Dict[str, np.ndarray],
    lr_dim: int,
    hr_dim: int,
    stats_file: Optional[str] = None,
    model=None,
    stats: Optional[Dict[str, float]] = None,
    use_aspect_ratio_correction: bool = False,
    lx: float = 1.0,
    ly: float = 1.0,
    use_adaptive_normalization: bool = False,
    blend_factor: float = 0.3,
    out_shape=None,
    aspect_mode: str = "identity",
    verbose: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Super-resolve {u, v, p} coarse fields to {u, v, p} fine fields (numpy
    float32, (ny, nx)). `model` is an SRModel or BicubicSR; `stats` may be
    passed instead of `stats_file`."""
    if stats is None:
        if stats_file is None:
            raise ValueError("need stats_file or stats")
        stats = read_stats_file(stats_file)
    stats_lr = component_stats(stats, lr_dim)
    stats_hr = component_stats(stats, hr_dim)
    if model is None:
        model = BicubicSR(lr_dim, hr_dim)

    aspect = bool(use_aspect_ratio_correction and (lx != ly))
    if aspect and aspect_mode == "extrapolate":
        from .resample import rect_to_square

        coarse_fields = rect_to_square(
            {c: np.asarray(coarse_fields[c]) for c in COMPONENTS}, lx, ly)
    src = np.stack([np.asarray(coarse_fields[c], np.float32) for c in COMPONENTS])
    if out_shape is None:
        out_shape = (hr_dim, hr_dim)
    if verbose:
        print(f"ML Super-Resolution ({lr_dim}x{lr_dim} -> {hr_dim}x{hr_dim})"
              f" | aspect_correction={'ON' if aspect else 'OFF'}"
              f" | adaptive_norm={'ON' if use_adaptive_normalization else 'OFF'}")

    def vec(st, k):
        return torch.tensor([st[c][k] for c in COMPONENTS],
                            dtype=torch.float32, device=device)

    pred = _sr_core(
        torch.as_tensor(src, device=device), vec(stats_lr, 0),
        vec(stats_lr, 1), vec(stats_hr, 0), vec(stats_hr, 1), model, lr_dim,
        tuple(out_shape), aspect and aspect_mode != "extrapolate",
        blend_factor, use_adaptive_normalization,
    ).cpu().numpy()

    hr_fields = {c: pred[i] for i, c in enumerate(COMPONENTS)}
    if aspect and aspect_mode == "extrapolate":
        from .resample import square_to_rect

        hr_fields = {
            c: np.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0).astype(np.float32)
            for c, v in square_to_rect(hr_fields, lx, ly).items()
        }
    if verbose:
        for c in COMPONENTS:
            print(f"  {c.upper()}: {coarse_fields[c].shape} -> "
                  f"{hr_fields[c].shape}, range [{hr_fields[c].min():.6f}, "
                  f"{hr_fields[c].max():.6f}]")
    return hr_fields
