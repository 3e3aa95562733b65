"""The big-grid kernel path through the solver, port against the JAX
package, float32: a 48^2 lid-driven cavity with `use_pallas=True` and
`mg_slab_rows=16`, which forces the path at any size (JAX
`solver/simple.py:106-109`). Momentum goes to the tiled momentum loop,
pressure to the streamed V-cycle; the JAX package runs its Pallas kernels
in interpret mode, the port (device="cpu") the kernels' plain versions.

Outer and inner counts must be equal. Fields: u and v within 2e-5
absolute, p within 2e-5 of max|p|, under the JAX package's own 5e-5 bound
for this path against its jnp step (tests/test_pallas_momentum.py).
"""

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.solver import cases as jcases
from sr_for_cfd_tpu.solver import simple as jsimple
from sr_for_cfd_tpu_torch.ops import momentum_kernels, stream_kernels
from sr_for_cfd_tpu_torch.solver import cases as tcases
from sr_for_cfd_tpu_torch.solver import simple as tsimple

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

KW = dict(Re=500, nx=48, ny=48, dt=2e-3, scheme="QUICK", dtype="float32",
          pressure_solver="multigrid", chunk_size=30, max_iterations=60,
          use_pallas=True, mg_slab_rows=16)


def _close(js, ts):
    for c in "uv":
        np.testing.assert_allclose(getattr(ts, c).numpy(),
                                   np.asarray(getattr(js, c)), rtol=0, atol=2e-5)
    jp = np.asarray(js.p)
    np.testing.assert_allclose(ts.p.numpy(), jp, rtol=0,
                               atol=2e-5 * np.abs(jp).max())


def test_forced_slab_steps_count_like_jax(capsys):
    """Three steps with their inner counts: u and v sweeps (multiples of
    3, the raised momentum_check_every) and the streamed V-cycles, and the
    notice of the raised cadence."""
    sj = jcases.make_cavity_solver(**KW)
    st = tcases.make_cavity_solver(device="cpu", **KW)
    js, ts = sj.state, st.state
    for _ in range(3):
        js, jc = jsimple.simple_step(js, sj.case, sj.profile, with_counts=True)
        ts, tc = tsimple.simple_step(ts, st.case, st.profile, nu=st._nu,
                                     with_counts=True)
        assert tc == {k: int(v) for k, v in jc.items()}
        assert tc["u"] % 3 == 0 and tc["v"] % 3 == 0 and tc["p"] >= 1
    _close(js, ts)
    assert ("[tiled-momentum] momentum_check_every 1 -> 3 (multi-sweep kernel "
            "passes; inner counts become multiples of 3)") in capsys.readouterr().out


def test_forced_slab_cavity_solve_matches_jax():
    """The whole solve (60 steps in chunks of 30) through `solve`: the
    outer count and the fields; the port's kernels are not launched on the
    CPU."""
    sj = jcases.make_cavity_solver(**KW)
    sj.solve("unused", verbose=False, save_results=False)
    for f in (momentum_kernels.tiled_solve_momentum,
              stream_kernels.stream_pass_a, stream_kernels.level1_correction,
              stream_kernels.stream_pass_b):
        f.launches = 0
    st = tcases.make_cavity_solver(device="cpu", **KW)
    st.solve("unused", verbose=False, save_results=False)
    assert st.state.count == int(sj.state.count) == 60
    _close(sj.state, st.state)
    assert momentum_kernels.tiled_solve_momentum.launches == 0
    assert stream_kernels.stream_pass_a.launches == 0


@pytest.mark.parametrize("kw", [dict(nx=47), dict(mg_n_pre=0)],
                         ids=["odd grid", "n_pre=0"])
def test_forced_slab_case_refused_like_jax(kw):
    for make in (jcases.make_cavity_solver, tcases.make_cavity_solver):
        args = dict(KW, **kw)
        if make is tcases.make_cavity_solver:
            args["device"] = "cpu"
        with pytest.raises(ValueError) as e:
            make(**args)
        if make is jcases.make_cavity_solver:
            j_msg = str(e.value)
    assert str(e.value) == j_msg
