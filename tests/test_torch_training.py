"""The port's SR training pipeline (`workflow/training.py`), its model side
(`models/standardize.py`, `models/autoencoder.py`, `SRModel.create`,
`io/checkpoint.py`'s writer) and `utils/timing.py` against the JAX
package's, on the CPU.

The training parity run hands the port's `_fit` JAX's initial weights
(`params_from_jax` of `SuperResolutionAE(10, 20).init`) and the same seed,
so both train on the same batches from the same start: the epoch losses
agree within 1e-4 relative and the final weights within 1e-4 of the
largest |weight| (XLA and PyTorch sum the convolutions' products in other
orders, ~1e-7 relative a step). Exported checkpoints predict within 1e-6
in the other package, the evaluation reports agree within 1e-5 relative.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sr_for_cfd_tpu.models import standardize as jstz
from sr_for_cfd_tpu.models.autoencoder import SuperResolutionAE as JaxAE
from sr_for_cfd_tpu.workflow import training as jtr
from sr_for_cfd_tpu_torch.io import checkpoint as tck
from sr_for_cfd_tpu_torch.models import autoencoder as tae
from sr_for_cfd_tpu_torch.models import standardize as tstz
from sr_for_cfd_tpu_torch.sr.inference import SRModel
from sr_for_cfd_tpu_torch.workflow import training as ttr

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "artifacts", "vanilla_superres_10to400_swish_tpu_multiBC.msgpack")


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(lr, hr, seed, latent=tae.LATENT_DIM):
    return _numpy(JaxAE(lr, hr, latent).init(jax.random.key(seed),
                                             jnp.zeros((1, lr, lr, 1), jnp.float32)))


def _data(n=16, seed=42):
    rng = np.random.default_rng(seed)
    x_hr = rng.standard_normal((n, 20, 20, 1)).astype(np.float32)
    return x_hr.reshape(n, 10, 2, 10, 2, 1).mean(axis=(2, 4)), x_hr


# ---- standardization --------------------------------------------------------

def _stats_inputs():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((12, 10, 10)) * 3.0 + 1.5).astype(np.float32)
    comps = np.array(["u", "v", "p"] * 4)
    return x, comps


@pytest.mark.parametrize("fn", ["standardize_with_stats", "inverse_standardize",
                                "dataset_standardize", "compute_component_stats",
                                "adaptive_blend"])
def test_standardization_is_bit_equal_to_jax(fn):
    x, comps = _stats_inputs()
    args = {"standardize_with_stats": (x, 0.25, 1e-12),
            "inverse_standardize": (x, 0.25, 3.5),
            "dataset_standardize": (x,),
            "compute_component_stats": (x, comps, 10),
            "adaptive_blend": (0.3, 1.7, x, 0.3)}[fn]
    got, want = getattr(tstz, fn)(*args), getattr(jstz, fn)(*args)
    if isinstance(want, dict):
        assert got == want
    else:
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_stats_file_is_jax_s(tmp_path):
    x, comps = _stats_inputs()
    stats = jstz.compute_component_stats(x, comps, 10)
    tstz.write_stats_file(str(tmp_path / "port.txt"), stats)
    jstz.write_stats_file(str(tmp_path / "jax.txt"), stats)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert tstz.read_stats_file(str(tmp_path / "port.txt")) == stats


@pytest.mark.parametrize("case", ["explicit", "default"])
def test_split_by_reynolds_config_is_jax_s(case):
    if case == "explicit":  # tests/test_training.py:25
        res = np.array([100, 200, 800, 100, 800])
        bcs = np.array(["a", "a", "a", "b", "b"])
        cfg = {"a": {"train": "ALL_EXCEPT_TEST", "test": [800]},
               "b": {"train": [100], "test": [800]}}
    else:
        rng = np.random.default_rng(3)
        res = rng.choice(np.arange(100, 801, 100), 60)
        bcs = rng.choice(np.array(["lid_driven_cavity", "double_lid(u_top=1,u_bottom=1)",
                                   "other"]), 60)
        cfg = None
    got, want = ttr.split_by_reynolds_config(res, bcs, cfg), jtr.split_by_reynolds_config(res, bcs, cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if case == "explicit":
        np.testing.assert_array_equal(got[0], [True, True, False, True, False])
        np.testing.assert_array_equal(got[1], [False, False, True, False, True])


def test_standardize_train_test_is_jax_s():
    x_lr, x_hr = _data(12)
    comps = np.array(["u", "v", "p"] * 4)
    train = np.arange(12) < 9
    got = ttr.standardize_train_test(x_lr, x_hr, comps, train, 10, 20)
    want = jtr.standardize_train_test(x_lr, x_hr, comps, train, 10, 20)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert ttr.DEFAULT_REYNOLDS_CONFIG == jtr.DEFAULT_REYNOLDS_CONFIG
    assert (ttr.DEFAULT_EPOCHS, ttr.DEFAULT_BATCH_SIZE, ttr.DEFAULT_LR) == \
        (jtr.DEFAULT_EPOCHS, jtr.DEFAULT_BATCH_SIZE, jtr.DEFAULT_LR)


# ---- training ---------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """JAX's train_sr_autoencoder and the port's _fit from JAX's init, on
    the same seeded 16 samples: 8 epochs of 2 steps, logged every 3."""
    x_lr, x_hr = _data()
    kw = dict(epochs=8, batch_size=8, seed=3, verbose=False, log_every=3)
    jr = jtr.train_sr_autoencoder(x_lr, x_hr, 10, 20, **kw)
    module = tae.SuperResolutionAE(10, 20)
    module.load_state_dict(tck.params_from_jax(_jax_init(10, 20, 3), 10, 20))
    tr = ttr._fit(module, x_lr, x_hr, device="cpu", **kw)
    return jr, tr


def test_fit_from_jax_init_matches_jax(trained):
    jr, tr = trained
    np.testing.assert_allclose(tr.loss_history, jr.loss_history, rtol=1e-4)
    assert len(tr.loss_history) == 8
    assert tr.best_epoch == jr.best_epoch
    np.testing.assert_allclose(tr.best_loss, jr.best_loss, rtol=1e-4)
    want = _numpy(jr.params)
    got = tck.params_to_jax(tr.params, 10, 20)
    scale = max(float(np.abs(a).max()) for a in jax.tree_util.tree_leaves(want))
    diffs = jax.tree_util.tree_map(lambda a, b: float(np.abs(a - b).max()), want, got)
    assert max(jax.tree_util.tree_leaves(diffs)) <= 1e-4 * scale
    assert tr.model.state_dict().keys() == tr.params.keys()


def test_keep_best_false_keeps_the_last_weights():
    x_lr, x_hr = _data()
    kw = dict(epochs=3, batch_size=8, seed=1, verbose=False, log_every=2, device="cpu")
    last = ttr.train_sr_autoencoder(x_lr, x_hr, 10, 20, keep_best=False, **kw)
    best = ttr.train_sr_autoencoder(x_lr, x_hr, 10, 20, keep_best=True, **kw)
    assert last.loss_history == best.loss_history
    assert best.best_epoch == int(np.argmin(best.loss_history))
    same = all(torch.equal(a, b) for a, b in zip(last.params.values(), best.params.values()))
    assert same == (best.best_epoch == 2)


def test_epoch_batches_are_jax_s():
    """The permutations JAX draws per block (`training.py:240-246`),
    including the wrap-around when n < batch_size."""
    for n, batch, block in ((16, 8, 3), (5, 8, 2)):
        steps = max(1, n // batch)
        rng, ref = np.random.default_rng(9), np.random.default_rng(9)
        got = ttr.epoch_indices(rng, n, steps, batch, block)
        per_epoch = steps * batch
        want = np.stack([np.tile(ref.permutation(n), -(-per_epoch // n))[:per_epoch]
                         .reshape(steps, batch) for _ in range(block)]).astype(np.int32)
        np.testing.assert_array_equal(got, want)


def test_adam_is_optax_s():
    import optax

    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    grads = [[rng.standard_normal(a.shape).astype(np.float32) for a in p0] for _ in range(4)]
    tx = optax.adam(1e-3)
    jp, st = [jnp.asarray(a) for a in p0], None
    st = tx.init(jp)
    tp = [torch.tensor(a) for a in p0]
    opt = ttr.Adam(tp, 1e-3)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.tensor(a) for a in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
    assert opt.count == 4


def test_training_refuses_the_mesh_and_plots(tmp_path):
    """The data-parallel mesh, refused naming A11 before it was ported (A11
    item 2): on the one-rank mesh of this process it trains bit for bit as
    without a mesh. `plot_dir` (refused until the plots were ported) writes
    the JAX package's comparison plots, one a sample, under the same
    names."""
    from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh

    x_lr, x_hr = _data(4)
    kw = dict(epochs=2, batch_size=3, verbose=False, device="cpu")
    one = ttr.train_sr_autoencoder(x_lr, x_hr, 10, 20, mesh=make_mesh(1), **kw)
    none = ttr.train_sr_autoencoder(x_lr, x_hr, 10, 20, **kw)
    assert one.loss_history == none.loss_history
    for k, v in none.params.items():
        assert torch.equal(one.params[k], v), k
    module = tae.SuperResolutionAE(10, 20)
    res, comps = np.array([100.0, 100.0, 100.0, 200.0]), np.array(["u", "v", "p", "u"])
    stats = {f"{k}{d}_{c}": 1.0 for k in ("mean", "std") for d in (10, 20) for c in "uvp"}
    ttr.evaluate_for_re(100, module, None, x_lr, x_hr, res, comps, stats, 10, 20,
                        plot_dir=str(tmp_path / "port"), verbose=False)
    jmodel = JaxAE(10, 20)
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 10, 10, 1)))
    jtr.evaluate_for_re(100, jmodel, jparams, x_lr, x_hr, res, comps, stats, 10, 20,
                        plot_dir=str(tmp_path / "jax"), verbose=False)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["sr_Re100_p.png", "sr_Re100_u.png", "sr_Re100_v.png"]


# ---- the model side ---------------------------------------------------------

def test_init_distribution_is_flax_s():
    """SRModel.create at full width (10 -> 400, 2,709,491 weights): every
    kernel's standard deviation within 5% of Flax's init of the same
    layer, |w| within the truncation at two standard deviations, biases
    zero. Layers under 20,000 weights are compared on draws pooled over
    seeds (Flax's lecun_normal on the layer's shape; the port's init on
    the layer alone), so that sampling noise stays under 1%."""
    from flax.linen import initializers

    model = SRModel.create(10, 400, rng_seed=0, device="cpu")
    assert tae.param_count(model.module) == tae.param_count(model.params) == 2709491
    got = tck.params_to_jax(model.params, 10, 400)["params"]
    want = _jax_init(10, 400, 0)["params"]
    assert tae.param_count(want) == 2709491
    modules = dict(model.module.named_modules())
    for part, layers in want.items():
        for name, layer in layers.items():
            k_w, k_g = layer["kernel"], got[part][name]["kernel"]
            assert k_g.shape == k_w.shape
            assert not got[part][name]["bias"].any()
            fan_in = int(np.prod(k_w.shape[:-1]))
            assert np.abs(k_g).max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978 * (1 + 1e-6)
            if k_w.size >= 20000:
                s_w, s_g = k_w.std(), k_g.std()
            else:
                reps = -(-50000 // k_w.size)
                init = initializers.lecun_normal()
                s_w = np.concatenate([np.asarray(init(jax.random.key(i), k_w.shape)).ravel()
                                      for i in range(reps)]).std()
                layer_mod = modules[tck_module_name(part, name)]
                draws = []
                for i in range(reps):
                    tae.flax_init_(layer_mod, torch.Generator().manual_seed(i))
                    draws.append(layer_mod.weight.detach().numpy().ravel().copy())
                s_g = np.concatenate(draws).std()
            assert abs(s_g / s_w - 1) < 0.05, (part, name, s_g, s_w)


def tck_module_name(part, name):
    """The port's module path of a Flax layer name."""
    if part == "encoder_lr":
        if name.startswith("conv2d"):
            i = 0 if name == "conv2d" else int(name.split("_")[1])
            return f"encoder_lr.convs.{i}"
        return f"encoder_lr.{name}"
    if name.startswith("conv_transpose_"):
        return f"decoder_hr.deconvs.{name.split('_')[-1]}"
    return f"decoder_hr.{name}"


def test_create_takes_given_params_as_they_are():
    p = _jax_init(10, 20, 5)
    from_tree = SRModel.create(10, 20, params=p, device="cpu")
    from_sd = SRModel.create(10, 20, params=tck.params_from_jax(p, 10, 20), device="cpu")
    for a, b in zip(from_tree.params.values(), from_sd.params.values()):
        assert torch.equal(a, b)
    a = SRModel.create(10, 20, rng_seed=4, device="cpu").params
    b = SRModel.create(10, 20, rng_seed=4, device="cpu").params
    c = SRModel.create(10, 20, rng_seed=5, device="cpu").params
    assert all(torch.equal(x, y) for x, y in zip(a.values(), b.values()))
    assert not torch.equal(a["decoder_hr.dense.weight"], c["decoder_hr.dense.weight"])
    assert tae.build_encoder(10).dense.in_features == 128 * 25
    assert tae.build_decoder(400).dense.out_features == 12 * 12 * 256
    with pytest.raises(ValueError, match="spec"):
        tae.build_encoder(11)


@pytest.mark.parametrize("lr,hr", [(10, 20), (10, 400), (50, 400)])
def test_params_to_jax_inverts_params_from_jax_exactly(lr, hr):
    p = _jax_init(lr, hr, 1)
    back = tck.params_to_jax(tck.params_from_jax(p, lr, hr), lr, hr)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(p)
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_msgpack_writer_gives_flax_s_bytes():
    """Reading the shipped checkpoint and writing it again gives its bytes;
    Flax's from_bytes reads what save_params writes."""
    with open(SHIPPED, "rb") as f:
        data = f.read()
    assert tck.to_msgpack(tck._Reader(data).value()) == data
    p = _jax_init(10, 20, 2)
    assert tck.to_msgpack(tck._Reader(serialization.to_bytes(p)).value()) == \
        serialization.to_bytes(p)
    tree = {"a": {"k": np.arange(300, dtype=np.int64).reshape(3, 100), "s": np.float32(2.5),
                  "x": 1.25, "n": -70000, "b": b"\x00" * 300, "c": 1 + 2j, "t": True,
                  "z": None, "l": [1, -3, 2 ** 40], "long_" + "k" * 40: "v" * 300}}
    assert tck.to_msgpack(tree) == serialization.msgpack_serialize(tree, in_place=True)


def test_load_params_checks_the_template(tmp_path):
    p = _jax_init(10, 20, 0)
    path = str(tmp_path / "m.msgpack")
    tck.save_params(path, p)
    got = tck.load_params(path, p)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(p)))
    bad = {"params": {"encoder_lr": p["params"]["encoder_lr"]}}
    with pytest.raises(ValueError, match="keys do not match"):
        tck.load_params(path, bad)


def test_export_models_loads_in_jax_and_back(trained, tmp_path, capsys, monkeypatch):
    """The port's export read by JAX's SRModel.from_checkpoint predicts
    within 1e-6 of the port's module; JAX's export read by the port's
    from_checkpoint predicts within 1e-6 of JAX's; the stats file and,
    without TensorFlow, the .h5 skip line are JAX's (the export through
    TensorFlow: tests/test_torch_keras.py)."""
    from sr_for_cfd_tpu.sr.inference import SRModel as JaxSRModel

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    jr, tr = trained
    stats = {f"{k}{d}_{c}": 0.5 for k in ("mean", "std") for d in (10, 20) for c in "uvp"}
    port_paths = ttr.export_models(tr, stats, 10, 20, "t", out_dir=str(tmp_path / "port"))
    out = capsys.readouterr().out
    assert out.startswith("  (Keras .h5 export skipped: ModuleNotFoundError: ")
    jax_paths = jtr.export_models(jr, stats, 10, 20, "t", out_dir=str(tmp_path / "jax"))
    assert capsys.readouterr().out == out
    assert sorted(port_paths) == sorted(jax_paths)
    for k in ("encoder", "decoder", "combined", "stats"):
        assert os.path.basename(port_paths[k]) == os.path.basename(jax_paths[k])
    assert open(port_paths["stats"]).read() == open(jax_paths["stats"]).read()
    x, _ = _data(4, seed=8)
    jm = JaxSRModel.from_checkpoint(port_paths["combined"], 10, 20)
    with torch.no_grad():
        ref = tr.model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(np.asarray(jm.predict(jnp.asarray(x))), ref, rtol=0, atol=1e-6)
    tm = SRModel.from_checkpoint(jax_paths["combined"], 10, 20, device="cpu")
    np.testing.assert_allclose(tm.predict(torch.tensor(x)).numpy(),
                               np.asarray(jr.model.apply(jr.params, jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    parts = {k: tck.read_msgpack(port_paths[k]) for k in ("encoder", "decoder")}
    tree = tck.params_to_jax(tr.params, 10, 20)["params"]
    for k, part in (("encoder", "encoder_lr"), ("decoder", "decoder_hr")):
        assert list(parts[k]["params"]) == list(tree[part])


def _eval_data():
    x_lr, x_hr = _data(6, seed=11)
    res = np.array([800.0, 800.0, 800.0, 300.0, 800.0, 300.0])
    comps = np.array(["u", "v", "p", "u", "u", "p"])
    stats = {f"mean{d}_{c}": 0.1 * i for i, c in enumerate("uvp") for d in (10, 20)}
    stats.update({f"std{d}_{c}": 1.5 + i for i, c in enumerate("uvp") for d in (10, 20)})
    return x_lr, x_hr, res, comps, stats


def _reports_close(got, want):
    assert [r["component"] for r in got["per_sample"]] == \
        [r["component"] for r in want["per_sample"]]
    for a, b in zip(got["per_sample"], want["per_sample"]):
        np.testing.assert_allclose([a["mae"], a["nmae_pct"]], [b["mae"], b["nmae_pct"]],
                                   rtol=1e-5)
    np.testing.assert_allclose([got["avg_mae"], got["avg_nmae_pct"]],
                               [want["avg_mae"], want["avg_nmae_pct"]], rtol=1e-5)


def test_evaluate_for_re_matches_jax(trained, capsys):
    jr, tr = trained
    x_lr, x_hr, res, comps, stats = _eval_data()
    want = jtr.evaluate_for_re(800, jr.model, jr.params, x_lr, x_hr, res, comps, stats, 10, 20)
    jout = capsys.readouterr().out
    got = ttr.evaluate_for_re(800, tr.model, tr.params, x_lr, x_hr, res, comps, stats, 10, 20)
    tout = capsys.readouterr().out
    assert len(got["per_sample"]) == 4
    _reports_close(got, want)
    assert tout.count("\n") == jout.count("\n") == 5
    empty = ttr.evaluate_for_re(500, tr.model, None, x_lr, x_hr, res, comps, stats, 10, 20,
                                verbose=False)
    assert empty["per_sample"] == [] and np.isnan(empty["avg_mae"])


def test_evaluate_shipped_model_matches_jax(tmp_path):
    """The shipped 10 -> 400 multiBC checkpoint and stats on a tiny file of
    Re 800 (and Re 700) groups, smooth seeded fields."""
    from sr_for_cfd_tpu.io.hdf5 import save_fields_hdf5
    from sr_for_cfd_tpu.config import MeshParameters

    path = str(tmp_path / "eval.h5")
    rng = np.random.default_rng(2)
    for re in (700, 800):
        coarse = {c: rng.standard_normal((5, 5)) for c in "uvp"}
        for n in (10, 400):
            f = {c: np.kron(v, np.ones((n // 5, n // 5))) * (1 + 0.1 * (c == "p"))
                 for c, v in coarse.items()}
            save_fields_hdf5(path, f, MeshParameters(nx=n, ny=n, lx=1.0, ly=1.0), re,
                             bc_type="double_lid(u_top=1,u_bottom=1)")
    art = os.path.dirname(SHIPPED)
    want = jtr.evaluate_shipped_model(10, 400, "swish_tpu_multiBC", [path], art_dir=art)
    got = ttr.evaluate_shipped_model(10, 400, "swish_tpu_multiBC", [path], art_dir=art,
                                     device="cpu")
    assert [r["component"] for r in got["per_sample"]] == ["u", "v", "p"]
    _reports_close(got, want)
    with pytest.raises(ValueError, match="no Re=600"):
        ttr.evaluate_shipped_model(10, 400, "swish_tpu_multiBC", [path], eval_re=600,
                                   art_dir=art, device="cpu")


def test_family_artifacts_are_jax_s():
    art = os.path.dirname(SHIPPED)
    assert ttr.family_artifact_paths(10, 400, "x", art) == jtr.family_artifact_paths(10, 400, "x", art)
    assert ttr.missing_family_artifacts(art) == jtr.missing_family_artifacts(art)


# ---- timing -----------------------------------------------------------------

def test_timing_on_the_cpu(tmp_path):
    from sr_for_cfd_tpu_torch.utils import timing

    x = torch.ones(64, 64)
    calls = []

    def fn(a, scale=1.0):
        calls.append(scale)
        return a @ a * scale

    t = timing.device_time(fn, x, reps=3, scale=2.0)
    assert 0.0 < t < 5.0 and calls == [2.0] * 3
    timer = timing.StepTimer()
    for _ in range(2):
        with timer.phase("solve"):
            fn(x)
    assert timer.counts == {"solve": 2} and timer.totals["solve"] > 0.0
    assert timer.summary().startswith("solve: ") and "avg over 2" in timer.summary()
    log_dir = tmp_path / "trace"
    with timing.profile_trace(str(log_dir)):
        with timing.trace_annotation("sr.region"):
            fn(x)
    traces = list(log_dir.iterdir())
    assert len(traces) == 1 and "sr.region" in traces[0].read_text()


def test_fit_times_itself_and_names_its_blocks():
    """`_fit` reports the seconds of its StepTimer phase and marks each
    block of `log_every` epochs as a `training.block` trace region."""
    x_lr, x_hr = _data()
    kw = dict(epochs=3, batch_size=8, seed=1, verbose=False, log_every=2, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr = ttr.train_sr_autoencoder(x_lr, x_hr, 10, 20, **kw)
    assert 0.0 < tr.seconds < 60.0
    blocks = [e for e in prof.key_averages() if e.key == "training.block"]
    assert len(blocks) == 1 and blocks[0].count == 2
