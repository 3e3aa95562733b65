"""The port's SR path against the JAX package: the msgpack reader against
flax.serialization, the 10->400 autoencoder with weights carried over by
`params_from_jax` against the Flax model on the shipped BFS checkpoint,
`resize_cubic` against jax.image.resize, and `ml_super_resolution`.

Float32 throughout. Tolerances: the AE's convolutions and dense layers sum
hundreds to thousands of products in another order on each side, ~1e-7
relative each; outputs are O(1), so 1e-5 absolute.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.models.autoencoder import SuperResolutionAE as FlaxAE
from sr_for_cfd_tpu.sr import inference as jinf
from sr_for_cfd_tpu_torch.io.checkpoint import load_sr_model, params_from_jax, read_msgpack
from sr_for_cfd_tpu_torch.models.autoencoder import SuperResolutionAE
from sr_for_cfd_tpu_torch.sr import inference as tinf

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "artifacts", "vanilla_superres_10to400_swish_tpu_bfs.msgpack")
STATS = os.path.join(ROOT, "artifacts", "standardization_stats_10to400_swish_tpu_bfs.txt")
ATOL = 1e-5


def _tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_msgpack_reader_matches_flax():
    from flax import serialization

    with open(MODEL, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    _tree_equal(read_msgpack(MODEL), ref)


def test_msgpack_reader_round_trips_flax_bytes(tmp_path):
    """Scalars, nested maps, ints, strings, and every array dtype flax
    writes."""
    from flax import serialization

    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "i": np.arange(3, dtype=np.int32), "d": np.float64(2.5) * np.ones((1,))},
            "s": np.float32(1.25), "n": 300, "neg": -7, "name": "swish",
            "z": 1.5 - 2j}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = read_msgpack(str(path))
    _tree_equal(got["a"], tree["a"])
    assert got["s"] == tree["s"] and got["n"] == 300 and got["neg"] == -7
    assert got["name"] == "swish" and got["z"] == 1.5 - 2j


def test_ae_10to400_matches_flax_on_shipped_checkpoint(rng):
    params = jinf.SRModel.from_checkpoint(MODEL, 10, 400).params
    x = rng.standard_normal((3, 10, 10, 1)).astype(np.float32)
    ref = np.asarray(FlaxAE(10, 400).apply(params, jnp.asarray(x)))
    model = load_sr_model(MODEL, 10, 400, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 400, 400, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_params_from_jax_matches_flax_with_same_padding(rng):
    """The 20->50 pair runs strided SAME convolutions and SAME and VALID
    transposed convolutions; random Flax weights carried across."""
    flax_model = FlaxAE(20, 50)
    params = flax_model.init(jax.random.key(0), jnp.zeros((1, 20, 20, 1)))
    x = rng.standard_normal((2, 20, 20, 1)).astype(np.float32)
    ref = np.asarray(flax_model.apply(params, jnp.asarray(x)))
    model = SuperResolutionAE(20, 50)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 20, 50))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape_in,shape_out", [
    ((3, 10, 10), (3, 32, 32)), ((2, 7, 12), (2, 3, 5)), ((3, 10, 10), (3, 10, 24))])
def test_resize_cubic_matches_jax_image_resize(shape_in, shape_out, rng):
    x = rng.standard_normal(shape_in)
    ref = jax.image.resize(jnp.asarray(x), shape_out, method="cubic")
    out = tinf.resize_cubic(torch.tensor(x), shape_out)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_adaptive_normalization=True, blend_factor=0.4),
    dict(use_aspect_ratio_correction=True, lx=10.0, ly=3.0, out_shape=(20, 28)),
    dict(use_aspect_ratio_correction=True, lx=10.0, ly=3.0,
         aspect_mode="extrapolate"),
])
def test_ml_super_resolution_bicubic_matches_jax(kw, rng):
    coarse = {c: rng.standard_normal((10, 10)).astype(np.float32) for c in "uvp"}
    stats = {f"{k}{d}_{c}": (0.1 if k == "mean" else 0.5)
             for k in ("mean", "std") for d in (10, 24) for c in "uvp"}
    ref = jinf.ml_super_resolution(coarse, 10, 24, stats=stats,
                                   model=jinf.BicubicSR(10, 24), verbose=False, **kw)
    out = tinf.ml_super_resolution(coarse, 10, 24, stats=stats,
                                   model=tinf.BicubicSR(10, 24), verbose=False,
                                   device="cpu", **kw)
    for c in "uvp":
        np.testing.assert_allclose(out[c], ref[c], rtol=0, atol=ATOL)


def test_ml_super_resolution_trained_model_matches_jax(rng):
    """The hybrid's SR step on the shipped BFS pair: BFS-like coarse
    fields, the shipped stats, NaN scrub and all."""
    coarse = {"u": rng.uniform(0, 1, (10, 10)), "v": rng.normal(0, 0.05, (10, 10)),
              "p": rng.normal(0, 0.1, (10, 10))}
    coarse = {c: a.astype(np.float32) for c, a in coarse.items()}
    ref = jinf.ml_super_resolution(
        coarse, 10, 400, stats_file=STATS,
        model=jinf.SRModel.from_checkpoint(MODEL, 10, 400), verbose=False)
    out = tinf.ml_super_resolution(
        coarse, 10, 400, stats_file=STATS,
        model=tinf.SRModel.from_checkpoint(MODEL, 10, 400, device="cpu"),
        verbose=False, device="cpu")
    for c in "uvp":
        assert out[c].shape == (400, 400) and out[c].dtype == np.float32
        np.testing.assert_allclose(out[c], ref[c], rtol=0, atol=ATOL)


def test_sr_predict_turns_tf32_off_only_for_its_forward_pass():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append((cudnn.allow_tf32, matmul.allow_tf32))
            return x

    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        tinf.SRModel(10, 400, Probe()).predict(torch.zeros(1, 10, 10, 1))
        assert seen == [(False, False)]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
