"""The port's hybrid workflow against the JAX package's, in float64 on
the CPU, at a small size: coarse 10x10 -> bicubic SR -> warm and cold
32x32 fine solves."""

import tempfile

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.workflow.hybrid import run_hybrid_experiment as jax_hybrid
from sr_for_cfd_tpu_torch.workflow.hybrid import run_hybrid_experiment as torch_hybrid

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)


def test_small_hybrid_matches_jax(tmp_path):
    """The hybrid in float64 with the bicubic fallback at hr_dim=32: coarse
    10x10 sweeps, SR, warm and cold 32x32 multigrid fine solves. Same
    iteration counts, same SR fields to float32 rounding (the SR path is
    float32 in both packages), same warm-vs-cold centerline differences
    (the JAX function returns those, not the fine fields)."""
    kw = dict(Re=100, lr_dim=10, hr_dim=32, case="bfs", max_iterations_coarse=100,
              max_iterations_ml=30, max_iterations_normal=40, verbose=False,
              save_results=False, dtype="float64", chunk_size=50,
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
