"""Import Keras .h5 encoder / decoder / combined SR checkpoints
(counterpart of `sr_for_cfd_tpu/models/keras_import.py`).

The reference keeps its trained models as Keras legacy-HDF5 files
(`model_weights/<layer>/<layer>/{kernel,bias}`). These functions read them
into the Flax-layout parameter tree of the JAX package, as numpy arrays:
Keras and Flax share HWIO conv kernels and (in, out) dense kernels, so the
encoder is a straight copy; a Keras Conv2DTranspose kernel is the Flax
`nn.ConvTranspose` kernel flipped spatially with its in/out axes swapped,
which the decoder import inverts. `io/checkpoint.params_from_jax` takes
the tree on to the port's `state_dict`.

h5py is imported inside the functions (through `io/hdf5._h5py`): a call
without it raises an `ImportError` that names it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..io.hdf5 import _h5py


def _model_weights(f, path: str):
    if "model_weights" not in f:
        raise ValueError(
            f"{path} has no 'model_weights' group - not a legacy-HDF5 "
            "Keras checkpoint"
        )
    return f["model_weights"]


def _read_layer_weights(group) -> Dict[str, Dict[str, np.ndarray]]:
    """Flatten one legacy-HDF5 `model_weights`-style group into
    {layer_name: {kernel, bias}} (Keras nests <layer>/<layer>/...)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for layer_name in group:
        grp = group[layer_name]
        inner = grp[layer_name] if layer_name in grp else grp
        entry = {}
        if "kernel" in inner:
            entry["kernel"] = np.array(inner["kernel"])
        if "bias" in inner:
            entry["bias"] = np.array(inner["bias"])
        if entry:
            out[layer_name] = entry
    return out


def load_keras_encoder_params(path: str) -> Dict:
    """Read a reference encoder .h5 into a Flax `params` tree for the
    Encoder (same layer names: conv2d, conv2d_1, ..., dense,
    latent_vector)."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        params = _read_layer_weights(_model_weights(f, path))
    if not params:
        raise ValueError(f"No weight tensors found in {path}")
    return {"params": params}


def _decoder_tree_from_layers(
    layers: Dict[str, Dict[str, np.ndarray]], path: str
) -> Dict:
    """Map Keras decoder layer weights onto the Flax Decoder param tree.

    Layers are classified by weight structure: the 2-D kernel is the latent
    Dense, 4-D kernels named *transpose* are the ConvTranspose ladder
    (kernel = spatial flip + in/out swap of the Flax kernel, inverted here
    - the exact inverse of `keras_export._conv_t_kernel`), and the
    remaining 4-D kernel is the final output conv."""
    transpose_names = sorted(
        n for n, e in layers.items()
        if "kernel" in e and e["kernel"].ndim == 4 and "transpose" in n
    )
    dense_names = [n for n, e in layers.items()
                   if "kernel" in e and e["kernel"].ndim == 2]
    out_names = [n for n, e in layers.items()
                 if "kernel" in e and e["kernel"].ndim == 4
                 and "transpose" not in n]
    if len(dense_names) != 1 or len(out_names) != 1 or not transpose_names:
        raise ValueError(
            f"{path} does not look like a decoder checkpoint: "
            f"dense={dense_names}, convT={transpose_names}, out={out_names}"
        )
    d = layers[dense_names[0]]
    params = {"dense": {"kernel": d["kernel"], "bias": d["bias"]}}
    for idx, name in enumerate(transpose_names):
        e = layers[name]
        # Keras Conv2DTranspose kernel (kh, kw, out, in) -> Flax
        # nn.ConvTranspose (kh, kw, in, out), spatially flipped back
        k = np.flip(e["kernel"], axis=(0, 1)).transpose(0, 1, 3, 2)
        params[f"conv_transpose_{idx}"] = {"kernel": k, "bias": e["bias"]}
    o = layers[out_names[0]]
    params["output_conv"] = {"kernel": o["kernel"], "bias": o["bias"]}
    return {"params": params}


def load_keras_decoder_params(path: str) -> Dict:
    """Read a Keras decoder .h5 into a Flax `params` tree for the Decoder
    - the inverse of `keras_export.export_decoder_h5`."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        layers = _read_layer_weights(_model_weights(f, path))
    return _decoder_tree_from_layers(layers, path)


def load_keras_combined_params(path: str) -> Dict:
    """Read a combined `superresolution*.h5` (encoder + decoder submodels,
    the reference's third export artifact) into a full SuperResolutionAE
    tree {'params': {'encoder_lr': ..., 'decoder_hr': ...}}."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        mw = _model_weights(f, path)
        enc_groups = [n for n in mw if n.startswith("encoder")]
        dec_groups = [n for n in mw if n.startswith("decoder")]
        if len(enc_groups) != 1 or len(dec_groups) != 1:
            raise ValueError(
                f"{path}: expected one encoder_* and one decoder_* "
                f"submodel, found {sorted(mw)}"
            )
        enc_layers = _read_layer_weights(mw[enc_groups[0]])
        dec_layers = _read_layer_weights(mw[dec_groups[0]])
    decoder = _decoder_tree_from_layers(dec_layers, path)["params"]
    return {"params": {"encoder_lr": enc_layers, "decoder_hr": decoder}}


def validate_encoder_params(variables: Dict, resolution: int, latent_dim: int = 50) -> None:
    """Shape-check an imported tree against the Encoder architecture."""
    from .autoencoder import ENCODER_SPECS

    params = variables["params"]
    for idx, (filters, kernel, _) in enumerate(ENCODER_SPECS[resolution]):
        name = "conv2d" if idx == 0 else f"conv2d_{idx}"
        k = params[name]["kernel"]
        if k.shape[:2] != (kernel, kernel) or k.shape[3] != filters:
            raise ValueError(
                f"{name}: expected ({kernel},{kernel},?,{filters}), got {k.shape}"
            )
    lv = params["latent_vector"]["kernel"]
    if lv.shape[1] != latent_dim:
        raise ValueError(f"latent_vector: expected (*, {latent_dim}), got {lv.shape}")
