"""The port's hybrid workflow against the JAX package's, in float64 on
the CPU, at a small size: coarse 10x10 -> bicubic SR -> warm and cold
32x32 fine solves."""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import sr_for_cfd_tpu.sr.inference as jinf
import sr_for_cfd_tpu_torch.sr.inference as tinf
from sr_for_cfd_tpu.workflow.hybrid import run_hybrid_experiment as jax_hybrid
from sr_for_cfd_tpu.workflow.hybrid import run_ml_accelerated_fine_simulation as jax_ml_fine
from sr_for_cfd_tpu_torch.workflow.hybrid import run_hybrid_experiment as torch_hybrid
from sr_for_cfd_tpu_torch.workflow.hybrid import (
    run_ml_accelerated_fine_simulation as torch_ml_fine,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)


def test_small_hybrid_matches_jax(tmp_path):
    """The hybrid in float64 with the bicubic fallback at hr_dim=32: coarse
    10x10 sweeps, SR, warm and cold 32x32 multigrid fine solves. Same
    iteration counts, same SR fields to float32 rounding (the SR path is
    float32 in both packages), same warm-vs-cold centerline differences
    (the JAX function returns those, not the fine fields)."""
    kw = dict(Re=100, lr_dim=10, hr_dim=32, case="bfs", max_iterations_coarse=50,
              max_iterations_ml=15, max_iterations_normal=20, verbose=False,
              save_results=False, dtype="float64", chunk_size=25,
              pressure_solver="multigrid",
              coarse_overrides={"pressure_solver": "sweeps"})
    rj = jax_hybrid(output_dir=tempfile.mkdtemp(dir=tmp_path), **kw)
    rt = torch_hybrid(device="cpu", **kw)
    assert rt["output_dir"] is None  # save_results=False creates no run directory
    for k in ("coarse_iterations", "ml_iterations", "normal_iterations"):
        assert rt[k] == rj[k]
    for c in "uvp":
        np.testing.assert_allclose(rt["hr_fields"][c], rj["hr_fields"][c],
                                   rtol=0, atol=1e-5)
    for name in ("U", "V"):
        for stat in ("max", "mean", "rms"):
            assert rt["centerline_diff"][name][stat] == pytest.approx(
                rj["centerline_diff"][name][stat], abs=1e-6)
    assert set(rt["ms_per_iteration"]) == {"coarse", "ml", "normal"}


def _record_from_parts(monkeypatch, module):
    """Wrap `module.SRModel.from_parts` to record the part files it loads."""
    calls = []
    real = module.SRModel.from_parts.__func__

    def from_parts(cls, encoder_file, decoder_file, *a, **k):
        calls.append((os.path.basename(encoder_file), os.path.basename(decoder_file)))
        return real(cls, encoder_file, decoder_file, *a, **k)

    monkeypatch.setattr(module.SRModel, "from_parts", classmethod(from_parts))
    return calls


@pytest.mark.parametrize("where", ["artifacts", "empty"])
def test_ml_fine_resolves_the_model_like_jax(where, tmp_path, monkeypatch, capsys):
    """`model_dir` and `model_suffix` pick the SR model as in the JAX
    package: in `artifacts` the shipped 10->400 BFS stats and split Keras
    .h5 encoder and decoder by their conventional names (no TF needed),
    in an empty directory the bicubic fallback with identity stats. Both
    packages load the same parts and give the same SR fields (one 400x400
    fine step each) to 1e-5 of max|value|, with the same fallback
    messages."""
    model_dir = os.path.join(ROOT, "artifacts") if where == "artifacts" else str(tmp_path)
    rng = np.random.default_rng(15)
    coarse = {c: rng.standard_normal((10, 10)).astype(np.float32) for c in "uvp"}
    kw = dict(lr_dim=10, hr_dim=400, model_dir=model_dir, model_suffix="swish_tpu_bfs",
              case="bfs", lx=10.0, ly=3.0, max_iterations=1, dt=2e-3, scheme="UPWIND",
              pressure_solver="multigrid", save_results=False)
    jcalls = _record_from_parts(monkeypatch, jinf)
    tcalls = _record_from_parts(monkeypatch, tinf)
    _, jn, _, jf = jax_ml_fine(400, 400, 400, coarse,
                               output_name=str(tmp_path / "jax"), **kw)
    jout = capsys.readouterr().out
    _, tn, _, tf = torch_ml_fine(400, 400, 400, coarse, device="cpu",
                                 output_name=str(tmp_path / "port"), **kw)
    tout = capsys.readouterr().out
    assert tn == jn == 1
    assert tcalls == jcalls == ([("vanilla_encoder10_to_400_swish_tpu_bfs.h5",
                                  "vanilla_decoder400_from_10_swish_tpu_bfs.h5")]
                                if where == "artifacts" else [])
    found = [ln for ln in jout.splitlines() if "not found" in ln]
    assert found == [ln for ln in tout.splitlines() if "not found" in ln]
    assert len(found) == (0 if where == "artifacts" else 1)
    for c in "uvp":
        ref = np.asarray(jf[c])
        np.testing.assert_allclose(tf[c], ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_conventional_h5_parts_without_h5py_raise_naming_it(monkeypatch):
    """Where the conventional .h5 parts exist and h5py does not import,
    the model load raises an ImportError naming h5py; it never falls back
    to bicubic. (The port imports h5py only inside the functions that need
    it, `tests/test_torch_imports.py`, so blocking it here blocks it for the
    whole call.)"""
    from sr_for_cfd_tpu_torch.workflow.hybrid import run_ml_accelerated_fine_simulation

    monkeypatch.setitem(sys.modules, "h5py", None)
    f = {c: np.zeros((10, 10), np.float32) for c in "uvp"}
    with pytest.raises(ImportError, match="h5py"):
        run_ml_accelerated_fine_simulation(
            400, 400, 400, f, hr_dim=400, case="bfs", model_dir=os.path.join(ROOT, "artifacts"),
            model_suffix="swish_tpu_bfs", device="cpu", save_results=False, verbose=False)
