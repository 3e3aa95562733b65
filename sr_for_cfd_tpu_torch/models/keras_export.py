"""Export SR autoencoder weights as Keras .h5 checkpoints (counterpart of
`sr_for_cfd_tpu/models/keras_export.py`).

The functions take the Flax-layout parameter tree that
`io/checkpoint.params_to_jax` makes from the port's `state_dict` and write
`vanilla_encoder{lr}_to_{hr}_*.h5`, `vanilla_decoder{hr}_from_{lr}_*.h5`
and the combined `superresolution{lr}to{hr}_*.h5` that the reference's
`tf.keras.models.load_model` workflow consumes
(`PyCFD_ML_accelerated.py:831-833`) and `models/keras_import.py` reads
back.

Weight conversions:
  * Conv2D / Dense: identical layouts (HWIO / (in, out)), straight copy.
  * Conv2DTranspose: Keras kernel = spatial flip + in/out swap of the Flax
    `nn.ConvTranspose` kernel.

TensorFlow is imported inside the functions: without it an export raises
`ModuleNotFoundError` and nothing else changes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .autoencoder import DECODER_SPECS, ENCODER_SPECS, LATENT_DIM


def _keras_encoder(resolution: int, latent_dim: int):
    from tensorflow.keras import Model, layers

    inp = layers.Input(shape=(resolution, resolution, 1),
                       name=f"encoder_{resolution}_input")
    x = inp
    # explicit layer names: Keras's global auto-naming counter would append
    # suffixes when other models exist in the session, breaking re-import
    for idx, (filters, kernel, stride) in enumerate(ENCODER_SPECS[resolution]):
        lname = "conv2d" if idx == 0 else f"conv2d_{idx}"
        x = layers.Conv2D(filters, kernel, strides=stride, padding="same",
                          activation="swish", name=lname)(x)
    x = layers.Flatten(name="flatten")(x)
    x = layers.Dense(128, activation="swish", name="dense")(x)
    z = layers.Dense(latent_dim, name="latent_vector")(x)
    return Model(inp, z, name=f"encoder_{resolution}")


def _keras_decoder(resolution: int, latent_dim: int):
    from tensorflow.keras import Model, layers

    shape, ladder = DECODER_SPECS[resolution]
    h, w, c = shape
    inp = layers.Input(shape=(latent_dim,),
                       name=f"decoder_{resolution}_input")
    x = layers.Dense(h * w * c, activation="swish", name="dense")(inp)
    x = layers.Reshape((h, w, c), name="reshape")(x)
    for idx, (filters, kernel, stride, padding) in enumerate(ladder):
        x = layers.Conv2DTranspose(
            filters, kernel, strides=stride, padding=padding.lower(),
            activation="swish", name=f"conv2d_transpose_{idx}",
        )(x)
    out = layers.Conv2D(1, 3, padding="same",
                        name=f"output_image_{resolution}")(x)
    return Model(inp, out, name=f"decoder_{resolution}")


def _conv_t_kernel(k: np.ndarray) -> np.ndarray:
    """Flax ConvTranspose kernel (kh, kw, in, out) -> Keras Conv2DTranspose
    kernel (kh, kw, out, in), spatially flipped."""
    return np.flip(k, axis=(0, 1)).transpose(0, 1, 3, 2)


def _encoder_weights(params: Dict, resolution: int) -> list:
    """The Encoder param subtree as Keras `set_weights` expects it."""
    weights = []
    for idx in range(len(ENCODER_SPECS[resolution])):
        name = "conv2d" if idx == 0 else f"conv2d_{idx}"
        weights += [np.asarray(params[name]["kernel"]),
                    np.asarray(params[name]["bias"])]
    for name in ("dense", "latent_vector"):
        weights += [np.asarray(params[name]["kernel"]),
                    np.asarray(params[name]["bias"])]
    return weights


def _decoder_weights(params: Dict, resolution: int) -> list:
    """The Decoder param subtree as Keras `set_weights` expects it."""
    _, ladder = DECODER_SPECS[resolution]
    weights = [np.asarray(params["dense"]["kernel"]),
               np.asarray(params["dense"]["bias"])]
    for idx in range(len(ladder)):
        p = params[f"conv_transpose_{idx}"]
        weights += [_conv_t_kernel(np.asarray(p["kernel"])),
                    np.asarray(p["bias"])]
    weights += [np.asarray(params["output_conv"]["kernel"]),
                np.asarray(params["output_conv"]["bias"])]
    return weights


def export_encoder_h5(params: Dict, resolution: int, path: str,
                      latent_dim: int = LATENT_DIM) -> str:
    """`params`: the Encoder param subtree ({'conv2d': ..., 'dense': ...})."""
    model = _keras_encoder(resolution, latent_dim)
    model.set_weights(_encoder_weights(params, resolution))
    model.save(path)
    return path


def export_decoder_h5(params: Dict, resolution: int, path: str,
                      latent_dim: int = LATENT_DIM) -> str:
    """`params`: the Decoder param subtree."""
    model = _keras_decoder(resolution, latent_dim)
    model.set_weights(_decoder_weights(params, resolution))
    model.save(path)
    return path


def export_superres_h5(variables: Dict, lr_dim: int, hr_dim: int,
                       encoder_path: str, decoder_path: str,
                       latent_dim: int = LATENT_DIM):
    """Export a combined SuperResolutionAE params tree to the reference's
    split encoder/decoder .h5 convention."""
    params = variables["params"]
    export_encoder_h5(params["encoder_lr"], lr_dim, encoder_path, latent_dim)
    export_decoder_h5(params["decoder_hr"], hr_dim, decoder_path, latent_dim)
    return encoder_path, decoder_path


def export_combined_h5(variables: Dict, lr_dim: int, hr_dim: int,
                       path: str, latent_dim: int = LATENT_DIM) -> str:
    """Export the single combined `superresolution{lr}to{hr}_*.h5` model
    (encoder and decoder as named submodels), the reference's third export
    artifact (`sr-ae-conv.ipynb` export cell). Re-importable via
    `keras_import.load_keras_combined_params`."""
    from tensorflow.keras import Model, layers

    params = variables["params"]
    enc = _keras_encoder(lr_dim, latent_dim)
    enc.set_weights(_encoder_weights(params["encoder_lr"], lr_dim))
    dec = _keras_decoder(hr_dim, latent_dim)
    dec.set_weights(_decoder_weights(params["decoder_hr"], hr_dim))
    inp = layers.Input(shape=(lr_dim, lr_dim, 1), name="superres_input")
    combined = Model(inp, dec(enc(inp)),
                     name=f"superresolution_{lr_dim}to{hr_dim}")
    combined.save(path)
    return path
