"""The port's Keras .h5 import and export against the JAX package's, on
the CPU, at the shipped 10->400 BFS width: the shipped encoder, decoder
and combined .h5 read bit-equal to JAX's `keras_import`; `from_parts` and
`from_combined_h5` predict as JAX's `SRModel` does; the port's export read
back by JAX's importer bit-equal to `params_to_jax`. The only test file
that imports TensorFlow."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.models import keras_import as jki
from sr_for_cfd_tpu.sr.inference import SRModel as JaxSRModel
from sr_for_cfd_tpu_torch.io.checkpoint import params_from_jax, params_to_jax
from sr_for_cfd_tpu_torch.models import keras_import as tki
from sr_for_cfd_tpu_torch.sr.inference import SRModel
from sr_for_cfd_tpu_torch.workflow import training as ttr

# more than one intra-op thread only adds overhead at these sizes
torch.set_num_threads(1)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")
ENC = os.path.join(ART, "vanilla_encoder10_to_400_swish_tpu_bfs.h5")
DEC = os.path.join(ART, "vanilla_decoder400_from_10_swish_tpu_bfs.h5")
COMBINED = os.path.join(ART, "superresolution10to400_swish_tpu_bfs.h5")


def assert_trees_equal(got, want, path=""):
    """Equal key sets at every level and bit-equal leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("load, path", [("load_keras_encoder_params", ENC),
                                        ("load_keras_decoder_params", DEC),
                                        ("load_keras_combined_params", COMBINED)],
                         ids=["encoder", "decoder", "combined"])
def test_shipped_h5_imports_bit_equal_to_jax(load, path):
    assert_trees_equal(getattr(tki, load)(path), getattr(jki, load)(path))


def test_validate_encoder_params_is_jax_s():
    tree = tki.load_keras_encoder_params(ENC)
    tki.validate_encoder_params(tree, 10)
    with pytest.raises(ValueError, match="latent_vector") as t:
        tki.validate_encoder_params(tree, 10, latent_dim=40)
    with pytest.raises(ValueError) as j:
        jki.validate_encoder_params(jki.load_keras_encoder_params(ENC), 10, latent_dim=40)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="not look like a decoder"):
        tki.load_keras_decoder_params(ENC)


@pytest.mark.parametrize("kind", ["parts_h5", "parts_msgpack", "combined_h5"])
def test_loaders_predict_like_jax(kind):
    """`from_parts` (.h5 and .msgpack parts) and `from_combined_h5` predict
    within 1e-5 of max|value| of the JAX package's `SRModel` loaded the
    same way, on a seeded input."""
    if kind == "combined_h5":
        jm = JaxSRModel.from_combined_h5(COMBINED, 10, 400)
        tm = SRModel.from_combined_h5(COMBINED, 10, 400, device="cpu")
    else:
        enc, dec = (ENC, DEC) if kind == "parts_h5" else (
            os.path.join(ART, "vanilla_encoder10_to_400_swish_tpu_bfs.msgpack"),
            os.path.join(ART, "vanilla_decoder400_from_10_swish_tpu_bfs.msgpack"))
        jm = JaxSRModel.from_parts(enc, dec, 10, 400)
        tm = SRModel.from_parts(enc, dec, 10, 400, device="cpu")
    x = np.random.default_rng(21).standard_normal((2, 10, 10, 1)).astype(np.float32)
    want = np.asarray(jm.predict(jnp.asarray(x)))
    got = tm.predict(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 400, 400, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_export_round_trip_through_jax_is_bit_equal(tmp_path, capsys):
    """The port's Keras export (split and combined, through
    `export_models` with TensorFlow present) read back by the JAX
    package's importer equals `params_to_jax` of the weights bit for bit,
    and the port's importer reads it back into the same state dict."""
    pytest.importorskip("tensorflow")
    model = SRModel.create(10, 400, rng_seed=4, device="cpu")
    result = ttr.TrainResult(params=model.params, model=model.module, loss_history=[1.0])
    stats = {f"{k}{d}_{c}": 0.5 for k in ("mean", "std") for d in (10, 400) for c in "uvp"}
    paths = ttr.export_models(result, stats, 10, 400, "rt", out_dir=str(tmp_path))
    assert "skipped" not in capsys.readouterr().out
    assert {os.path.basename(paths[k]) for k in ("encoder_h5", "decoder_h5", "combined_h5")} \
        == {"vanilla_encoder10_to_400_rt.h5", "vanilla_decoder400_from_10_rt.h5",
            "superresolution10to400_rt.h5"}
    tree = params_to_jax(model.params, 10, 400)
    assert_trees_equal(jki.load_keras_combined_params(paths["combined_h5"]), tree)
    assert_trees_equal(jki.load_keras_encoder_params(paths["encoder_h5"])["params"],
                       tree["params"]["encoder_lr"])
    assert_trees_equal(jki.load_keras_decoder_params(paths["decoder_h5"])["params"],
                       tree["params"]["decoder_hr"])
    back = params_from_jax(tki.load_keras_combined_params(paths["combined_h5"]), 10, 400)
    for k, v in model.params.items():
        assert torch.equal(back[k], v), k
