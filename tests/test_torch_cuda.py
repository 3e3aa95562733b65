"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test skips without a CUDA card. This file imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Float32 on both sides; they round differently (reciprocal multiply vs
divide, fused multiply-adds, summation order), ~1e-7 relative per
operation, and the iterations are contractive: 2e-5 of the largest value.
"""

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu_torch.ops.mg_kernels import _Tally, mg_solve_pressure_kernel
from sr_for_cfd_tpu_torch.ops.multigrid import mg_solve_pressure
from sr_for_cfd_tpu_torch.ops.pressure_kernels import (
    solve_pressure_kernel,
    solve_pressure_plain,
)
from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes
from sr_for_cfd_tpu_torch.ops.step_kernels import (
    simple_step_kernel,
    simple_step_plain,
)
from sr_for_cfd_tpu_torch.solver.cases import make_bfs_solver, make_cavity_solver

REL_TOL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _problem(seed, nx, ny, lx, ly, device):
    rng = np.random.default_rng(seed)

    def field(scale):
        return torch.tensor(rng.standard_normal((nx + 2, ny + 2)) * scale,
                            dtype=torch.float32, device=device)

    u, v, p = field(0.1), field(0.1), field(0.01)
    dx, dy = lx / nx, ly / ny
    return p, face_fluxes(u, v, dx, dy), dict(dx=dx, dy=dy, dt=2e-3, rho=1.0,
                                               volp=dx * dy)


def _close(out, ref):
    torch.cuda.synchronize()
    tol = REL_TOL * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 60, 400])
def test_rb_sor_kernel_matches_plain(card, n):
    """The one-warp loop (12x12), the single-block loop (62x62) and
    per-half-sweep launches (402x402); 64 sweeps, no early exit."""
    p, ff, geo = _problem(n, n, n, 10.0, 3.0, card)
    kw = dict(geo, tol=0.0, max_iter=64, check_every=8, sor=1.0)
    out, n_out = solve_pressure_kernel(p, ff, **kw)
    ref, n_ref = solve_pressure_plain(p, ff, **kw)
    _close(out, ref)
    assert n_out == n_ref == 64
    assert torch.equal(out[0], p[0]) and torch.equal(out[:, -1], p[:, -1])


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,lx,ly", [(400, 400, 10.0, 3.0), (40, 12, 10.0, 3.0),
                                         (33, 47, 1.0, 1.0)])
def test_mg_kernel_matches_plain(card, nx, ny, lx, ly):
    """The hybrid's fine grid, an anisotropic semi-coarsened grid and odd
    sizes (banded row transfers); 3 cycles, no early exit."""
    p, ff, geo = _problem(nx + ny, nx, ny, lx, ly, card)
    kw = dict(geo, tol=1e-30, max_cycles=3)
    out, n_out = mg_solve_pressure_kernel(p, ff, **kw)
    ref, n_ref = mg_solve_pressure(p, ff, **kw)
    _close(out, ref)
    assert n_out == n_ref == 3


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    p = torch.zeros((12, 12), dtype=torch.float64, device=card)
    ff = face_fluxes(p, p, 0.1, 0.1)
    kw = dict(dx=0.1, dy=0.1, dt=1e-3, rho=1.0, volp=0.01)
    with pytest.raises(ValueError, match="float32"):
        solve_pressure_kernel(p, ff, **kw)
    with pytest.raises(ValueError, match="float32"):
        mg_solve_pressure_kernel(p, ff, **kw)
    # dense but transposed: the kernels read row-major fields
    pt = torch.zeros((14, 12), dtype=torch.float32, device=card).T
    fft = face_fluxes(pt.contiguous(), pt.contiguous(), 0.1, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        solve_pressure_kernel(pt, fft, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        mg_solve_pressure_kernel(pt, fft, **kw)


@pytest.mark.cuda
def test_kernel_step_matches_plain_step(card):
    """Ten BFS steps on the card through the kernels against the plain
    PyTorch path on the CPU, float32."""
    from sr_for_cfd_tpu_torch.solver.cases import make_bfs_solver

    kw = dict(nx=40, ny=40, dtype="float32", use_pallas=True,
              pressure_solver="multigrid", max_iterations=10, chunk_size=10)
    gpu = make_bfs_solver(device=card, **kw)
    cpu = make_bfs_solver(device="cpu", **kw)
    assert gpu.solve(verbose=False, save_results=False)[0] == 10
    assert cpu.solve(verbose=False, save_results=False)[0] == 10
    a, b = gpu.interior_fields(), cpu.interior_fields()
    for c in "uvp":
        scale = max(1.0, float(np.abs(b[c]).max()))
        np.testing.assert_allclose(a[c], b[c], rtol=0, atol=1e-4 * scale)


# whole-step kernel: (design, solver maker, settings); inner tolerances the
# loops reach before the float32 floor, so that the counts can be equal
FUSED = {
    "a_bfs10_coarse_k50": ("a", make_bfs_solver, dict(
        nx=10, ny=10, scheme="UPWIND", pressure_sor=1.5, inner_max_iter=64,
        inner_tolerance=1e-3, steps_per_kernel=50)),
    "a_cavity16_quick_k4": ("a", make_cavity_solver, dict(
        Re=100, nx=16, ny=16, dt=2e-3, scheme="QUICK", steps_per_kernel=4)),
    # 185 KB of shared memory: past the 48 KB a block gets without opting in
    "a_cavity60_upwind_k2": ("a", make_cavity_solver, dict(
        Re=100, nx=60, ny=60, dt=2e-3, scheme="UPWIND", inner_tolerance=1e-3,
        steps_per_kernel=2)),
    "b_cavity64_quick_k2": ("b", make_cavity_solver, dict(
        Re=100, nx=64, ny=64, dt=2e-3, scheme="QUICK", inner_tolerance=1e-3,
        steps_per_kernel=2)),
    "b_bfs40_multigrid_k2": ("b", make_bfs_solver, dict(
        nx=40, ny=40, pressure_solver="multigrid", inner_tolerance=1e-3,
        steps_per_kernel=2)),
}


def _fused_solver(make, device, **kw):
    solver = make(device=device, dtype="float32", fused_step=True,
                  chunk_size=kw["steps_per_kernel"], **kw)
    rng = np.random.default_rng(kw["nx"])
    nx, ny = solver.mesh.nx, solver.mesh.ny
    coarse = {c: torch.tensor(rng.standard_normal((1, 1, 8, 8)) * 0.1) for c in "uvp"}
    solver.warm_start({c: torch.nn.functional.interpolate(
        f, size=(ny, nx), mode="bicubic", align_corners=True)[0, 0].numpy()
        for c, f in coarse.items()})
    return solver


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FUSED))
def test_fused_step_kernel_matches_plain(card, name):
    """Designs (a) and (b) against the plain version on the same seeded
    state: fields and fluxes within 2e-5 of the largest value, equal
    counts."""
    design, make, kw = FUSED[name]
    solver = _fused_solver(make, card, **kw)
    s = solver.state
    args = (s.u, s.v, s.p, s.ff, solver.case, solver.profile)
    out = simple_step_kernel(*args, nu=solver._nu, _design=design)
    ref = simple_step_plain(*args, nu=solver._nu)
    for a, b in zip((*out[:3], *out[3]), (*ref[:3], *ref[3])):
        _close(a, b)
    assert out[5] == ref[5]
    torch.testing.assert_close(out[4], ref[4], rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_fused_wrapper_raises_on_what_the_kernel_does_not_take(card):
    solver = _fused_solver(make_cavity_solver, card, nx=16, ny=16,
                           steps_per_kernel=1)
    s = solver.state
    rest = (s.ff, solver.case, solver.profile)
    with pytest.raises(ValueError, match="float32"):
        simple_step_kernel(s.u.double(), s.v, s.p, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        simple_step_kernel(s.u.T, s.v, s.p, *rest)
    mg = _fused_solver(make_cavity_solver, card, nx=16, ny=16, steps_per_kernel=1,
                       pressure_solver="multigrid")
    with pytest.raises(ValueError, match="design"):
        simple_step_kernel(mg.state.u, mg.state.v, mg.state.p, mg.state.ff,
                           mg.case, mg.profile, _design="a")


@pytest.mark.cuda
@pytest.mark.parametrize("design", [None, "b"])
def test_fused_solver_on_the_card_matches_the_cpu(card, design):
    """A BFS 10x10 solve of the coarse phase's settings (500 steps, 50
    per launch) on the card and on the CPU: equal counts, fields within
    1e-4 of the largest value."""
    kw = dict(nx=10, ny=10, dtype="float32", fused_step=True,
              steps_per_kernel=50, pressure_sor=1.5, inner_max_iter=64,
              max_iterations=500, chunk_size=500, inner_tolerance=1e-3)
    gpu = make_bfs_solver(device=card, **kw)
    cpu = make_bfs_solver(device="cpu", **kw)
    simple_step_kernel.force_design = design
    try:
        assert gpu.solve(verbose=False, save_results=False)[0] == 500
    finally:
        simple_step_kernel.force_design = None
    assert cpu.solve(verbose=False, save_results=False)[0] == 500
    a, b = gpu.interior_fields(), cpu.interior_fields()
    for c in "uvp":
        scale = max(1.0, float(np.abs(b[c]).max()))
        np.testing.assert_allclose(a[c], b[c], rtol=0, atol=1e-4 * scale)


@pytest.mark.cuda
def test_rb_sor_divide_form_matches_plain(card):
    """The divide form of the SOR kernel ((sor r) / ap_d, design (b)'s
    point-iteration pressure) against its plain version, on the BFS
    spacing where 1/ap_d is not exact: single-block and many-block."""
    for n in (10, 400):
        p, ff, geo = _problem(n, n, n, 10.0, 3.0, card)
        kw = dict(geo, tol=0.0, max_iter=64, check_every=8, sor=1.0, divide=True)
        out, n_out = solve_pressure_kernel(p, ff, **kw)
        ref, n_ref = solve_pressure_plain(p, ff, **kw)
        _close(out, ref)
        assert n_out == n_ref == 64


# (nx, ny, tol, max_iter): 64 sweeps; a solve the stall policy ends at the
# float32 floor (the BFS 10x10 spacing); one that ends on tolerance;
# max_iter cutting a check short; the one-warp route's edges
RB_WARP_CASES = {
    "64 sweeps": (10, 10, 0.0, 64), "stall": (10, 10, 1e-6, 1000),
    "tolerance": (10, 10, 1e-4, 1000), "max_iter 1": (10, 10, 0.0, 1),
    "max_iter 7": (10, 10, 0.0, 7), "max_iter 9": (10, 10, 0.0, 9),
    "nx2 32": (30, 7, 1e-5, 300), "ny2 32": (7, 30, 0.0, 96),
    "32x32": (30, 30, 0.0, 40), "20x20": (20, 20, 1e-6, 1000)}


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("case", list(RB_WARP_CASES))
def test_rb_warp_kernel_is_bit_equal_to_the_block_loop(card, case, divide):
    """Row 1's one-warp kernel (b built inside) against the single-block
    loop it replaced on the 12x12 route (b built on the host): field, count
    and the last rms bit-equal; within REL_TOL of the plain version with
    equal counts where the loop stops away from the float32 floor."""
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import card_solve

    nx, ny, tol, max_iter = RB_WARP_CASES[case]
    p, ff, geo = _problem(nx * 37 + ny, nx, ny, 10.0, 3.0, card)
    kw = dict(geo, tol=tol, max_iter=max_iter, check_every=8, sor=1.0, divide=divide)
    out, n, rms = card_solve(p, ff, **kw, _kernel="warp")
    ref, n_ref, rms_ref = card_solve(p, ff, **kw, _kernel="block")
    torch.cuda.synchronize()
    assert _same_bits(out, ref) and n == n_ref
    assert np.float32(rms).tobytes() == np.float32(rms_ref).tobytes()
    if case in ("stall", "20x20"):
        assert n < max_iter and rms >= np.float32(tol)
        return
    if tol > 0:
        assert rms < np.float32(tol) and n < max_iter
    else:
        assert n == -(-max_iter // 8) * 8
    plain, n_plain = solve_pressure_plain(p, ff, **kw)
    _close(out, plain)
    assert n == n_plain


@pytest.mark.cuda
def test_rb_warp_route_runs_one_device_kernel_per_call(card):
    """torch.profiler: a call on the one-warp route runs its kernel and
    nothing else on the card (the old route ran b's fill, adds, multiply
    and copy and p's copy besides)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sr_for_cfd_tpu_torch.ops.pressure_kernels import card_solve

    p, ff, geo = _problem(10, 10, 10, 10.0, 3.0, card)
    kw = dict(geo, tol=0.0, max_iter=64, check_every=8, sor=1.0)

    def kernels(fn, calls=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                and "Memcpy" not in e.name and "Memset" not in e.name]

    new = kernels(lambda: solve_pressure_kernel(p, ff, **kw))
    assert len(new) == 5 and all("rb_sor_warp_kernel" in k for k in new), new
    old = kernels(lambda: card_solve(p, ff, **kw, _kernel="block"))
    assert len(old) > 5 and sum("rb_sor_loop_small_kernel" in k for k in old) == 5, old


@pytest.mark.cuda
def test_rb_warp_route_raises_on_fluxes_it_does_not_take(card):
    p, ff, geo = _problem(10, 10, 10, 10.0, 3.0, card)
    kw = dict(geo, tol=0.0, max_iter=8)
    for bad, match in ((ff._replace(n=ff.n.T.contiguous().T), "contiguous"),
                       (ff._replace(w=ff.w[:, :-1].contiguous()), r"takes a \(10, 10\)"),
                       (ff._replace(s=ff.s.double()), "float32"),
                       (ff._replace(e=ff.e.cpu()), "CUDA")):
        with pytest.raises(ValueError, match=match):
            solve_pressure_kernel(p, bad, **kw)
    with pytest.raises(ValueError, match="kernel"):
        from sr_for_cfd_tpu_torch.ops.pressure_kernels import card_solve

        card_solve(p, ff, **kw, _kernel="two_launch")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,check_every", [("QUICK", 3), ("UPWIND", 1)])
def test_tiled_momentum_kernel_matches_plain(card, scheme, check_every):
    """The ragged 72-row problem of the CPU parity test: same sweep count,
    fields within 2e-5 of the largest value."""
    from sr_for_cfd_tpu_torch.ops.momentum_kernels import (
        tiled_solve_momentum,
        tiled_solve_momentum_plain,
    )

    n = 72
    rng = np.random.default_rng(3)
    u = torch.tensor(rng.standard_normal((n + 2, n + 2)) * 0.3,
                     dtype=torch.float32, device=card)
    v = torch.tensor(rng.standard_normal((n + 2, n + 2)) * 0.3,
                     dtype=torch.float32, device=card)
    old = u[1:-1, 1:-1] + torch.tensor(rng.standard_normal((n, n)) * 0.01,
                                       dtype=torch.float32, device=card)
    ff = face_fluxes(u, v, 1.0 / n, 1.0 / n)
    kw = dict(scheme=scheme, dx=1.0 / n, dy=1.0 / n, dt=1e-3, nu=0.01,
              volp=1.0 / n**2, tol=1e-6, max_iter=40, check_every=check_every)
    before = tiled_solve_momentum.launches
    out, n_out = tiled_solve_momentum(u, old, ff, return_count=True, **kw)
    assert tiled_solve_momentum.launches > before
    ref, n_ref = tiled_solve_momentum_plain(u, old, ff, **kw)
    _close(out, ref)
    assert n_out == n_ref and n_out % check_every == 0


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,lx,ly", [(72, 64, 1.0, 1.0), (64, 48, 10.0, 3.0),
                                         (48, 64, 3.0, 10.0)])
def test_streamed_passes_match_plain(card, nx, ny, lx, ly):
    """Pass A, the level-1 correction and pass B, each against its plain
    version on the same inputs, then two forced streamed cycles."""
    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk
    from sr_for_cfd_tpu_torch.ops.multigrid import frozen_ghost_rhs

    p, ff, geo = _problem(nx + ny, nx, ny, lx, ly, card)
    lv = sk.StreamLevels(nx, ny, geo["dx"], geo["dy"], geo["volp"], card)
    inv_dx2, inv_dy2 = lv.setup.spacings[0]
    b = frozen_ghost_rhs(p, ff, geo["dt"], geo["rho"], geo["volp"],
                         inv_dx2, inv_dy2).contiguous()
    x = p[1:-1, 1:-1].contiguous()
    xa, b1, rms = sk.stream_pass_a(x, b, lv)
    xa_ref, b1_ref, rms_ref = sk.stream_pass_a_plain(x, b, lv)
    _close(xa, xa_ref)
    _close(b1, b1_ref)
    assert abs(rms.item() - rms_ref.item()) <= 1e-6 * rms_ref.item()
    e = sk.level1_correction(b1_ref, lv)
    e_ref = sk.level1_correction_plain(b1_ref, lv)
    _close(e, e_ref)
    xb = sk.stream_pass_b(xa_ref.clone(), b, e_ref, lv)
    _close(xb, sk.stream_pass_b_plain(xa_ref, b, e_ref, lv))
    kw = dict(geo, tol=1e-30, max_cycles=2, return_count=True)
    out, n_out = sk.stream_mg_solve_pressure(p, ff, **kw)
    ref, n_ref = sk.stream_mg_solve_pressure(p.cpu(), type(ff)(*(t.cpu() for t in ff)),
                                             **kw)
    _close(out.cpu(), ref)
    assert n_out == n_ref == 2
    assert torch.equal(out[0], p[0]) and torch.equal(out[:, -1], p[:, -1])


@pytest.mark.cuda
def test_big_grid_solve_matches_cpu(card):
    """The forced-slab cavity through the big-grid kernels on the card
    against the plain path on the CPU: equal counts, fields within 1e-4 of
    the largest value."""
    kw = dict(Re=500, nx=48, ny=48, dt=2e-3, scheme="QUICK", dtype="float32",
              pressure_solver="multigrid", chunk_size=30, max_iterations=60,
              use_pallas=True, mg_slab_rows=16)
    gpu = make_cavity_solver(device=card, **kw)
    cpu = make_cavity_solver(device="cpu", **kw)
    assert gpu.solve(verbose=False, save_results=False)[0] == 60
    assert cpu.solve(verbose=False, save_results=False)[0] == 60
    a, b = gpu.interior_fields(), cpu.interior_fields()
    for c in "uvp":
        scale = max(1.0, float(np.abs(b[c]).max()))
        np.testing.assert_allclose(a[c], b[c], rtol=0, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("lx,ly", [(1.0, 1.0), (10.0, 3.0)])
def test_tiled_sweep_matches_plain(card, lx, ly):
    """The tiled red-black sweep (row 5) on a 130x97 grid, which no tile
    divides: one sweep bit-equal to the plain version, and a solve at omega
    1.9 with equal counts and fields, also against row 1's two-launch form
    (divide=True, check_every=1), which computes the same function. The
    device-exit loop launches whole batches, one more than it reads, and
    reads the state once per batch."""
    import math

    from sr_for_cfd_tpu_torch.ops.tiled_kernels import BATCH, tiled_solve_pressure

    p, ff, geo = _problem(130 + 97, 130, 97, lx, ly, card)
    kw = dict(geo, sor=1.9)
    row1 = dict(kw, check_every=1, divide=True)
    out, n_out = tiled_solve_pressure(p, ff, **kw, tol=0.0, max_iter=1)
    ref, n_ref = solve_pressure_plain(p, ff, **row1, tol=0.0, max_iter=1)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and n_out == n_ref == 1
    before = tiled_solve_pressure.launches
    reads = tiled_solve_pressure.reads
    out, n_out = tiled_solve_pressure(p, ff, **kw, tol=1e-3, max_iter=300)
    batches = math.ceil(n_out / BATCH)
    assert tiled_solve_pressure.reads == reads + batches
    # and the batch after it, enqueued before the read (no-op launches)
    assert tiled_solve_pressure.launches == before + min((batches + 1) * BATCH, 300)
    ref, n_ref = solve_pressure_plain(p, ff, **row1, tol=1e-3, max_iter=300)
    two, n_two = solve_pressure_kernel(p, ff, **row1, tol=1e-3, max_iter=300)
    _close(out, ref)
    _close(two, out)
    assert n_out == n_ref == n_two < 300
    assert torch.equal(out[0], p[0]) and torch.equal(out[:, -1], p[:, -1])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["default plan", "tile 32"])
def test_tiled_device_exit_matches_host_exit(card, form):
    """The device-exit loop (on its own plan, and on 32-cell tiles)
    against the host-exit loop (the one-sweep kernel, a finalize and a host read per
    sweep) on the 130x97 grid: bit-equal fields and equal counts with the
    exit by max_iter at every position of a batch, by the tolerance and by
    the stall policy (tol 0 on a 34x30 grid: the rms reaches the float32
    floor)."""
    from sr_for_cfd_tpu_torch.ops import shard_rb
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import _coefficients
    from sr_for_cfd_tpu_torch.ops.tiled_kernels import (
        BATCH,
        _tiled_solve_pressure_host_exit,
        _TiledLoop,
    )

    for nx, ny, tols, iters in ((130, 97, (0.0, 1e-3), range(1, 2 * BATCH + 2)),
                                (34, 30, (0.0,), (20000,))):
        p, ff, geo = _problem(nx + ny, nx, ny, 1.0, 1.0, card)
        inv_dx2, inv_dy2, sor, _, ap_d = _coefficients(geo["dx"], geo["dy"], geo["volp"],
                                                       1.9, nx, ny)
        plan = None if form == "default plan" else shard_rb.shard_rb_plan(
            nx + 2, ny + 2, 1, 1, ot=32)
        rhs = (geo["rho"] / geo["dt"]) * ff.divergence_sum()
        for tol in tols:
            for max_iter in (iters if tol == 0.0 else (300,)):
                loop = _TiledLoop(nx + 2, ny + 2, card, inv_dx2, inv_dy2, geo["volp"], sor,
                                  ap_d, tol, max_iter, _plan=plan)
                out, n = loop.solve(p, rhs)
                ref, n_ref = _tiled_solve_pressure_host_exit(p, ff, **geo, sor=1.9, tol=tol,
                                                             max_iter=max_iter)
                torch.cuda.synchronize()
                assert n == n_ref and torch.equal(out, ref), (nx, tol, max_iter)
                if nx == 34:
                    assert n < max_iter  # the stall policy ended it
                elif tol == 0.0:
                    assert n == max_iter


@pytest.mark.cuda
def test_tiled_wrapper_raises_on_what_the_kernel_does_not_take(card):
    from sr_for_cfd_tpu_torch.ops.tiled_kernels import tiled_solve_pressure

    kw = dict(dx=0.1, dy=0.1, dt=1e-3, rho=1.0, volp=0.01)
    p = torch.zeros((12, 12), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="float32"):
        tiled_solve_pressure(p, face_fluxes(p, p, 0.1, 0.1), **kw)
    pt = torch.zeros((14, 12), dtype=torch.float32, device=card).T
    fft = face_fluxes(pt.contiguous(), pt.contiguous(), 0.1, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tiled_solve_pressure(pt, fft, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kb,layout", [(1, "interior"), (3, "interior"), (8, "interior"),
                                       (8, "one rank, ghost rows"),
                                       (4, "one rank, zero exterior")])
def test_shard_sweep_matches_plain(card, kb, layout):
    """The per-rank red-black sweep (row 9) against its plain version and
    the staged form (kb one-sweep launches and the sum): own rows and the
    residual sum bit-equal, one launch. Blocks no tile divides: a 130x97
    block of an interior rank (row0 500 of 2048 rows), and one rank's block
    of 100x97 cells (row0 0, both ends beyond the domain) as the sweeps
    route builds it (the ghost row repeated beyond the domain) and as the
    V-cycle smoother does (zero rows and columns beyond it)."""
    from sr_for_cfd_tpu_torch.parallel.spmd_kernels import (
        _shard_rb_sweep_staged,
        shard_rb_sweep,
        shard_rb_sweep_plain,
    )

    g = np.random.default_rng(kb)
    h = 2 * kb
    if layout == "interior":
        ext, b = (torch.tensor(g.standard_normal((130, 97)), dtype=torch.float32,
                               device=card) for _ in range(2))
        row0, nxg, rows, width = 500, 2048, 130 - 2 * h, 97
    else:
        x, b = (torch.tensor(g.standard_normal((100, 97)), dtype=torch.float32,
                             device=card) for _ in range(2))
        row0, nxg, rows, width = 0, 100, 100, 99
        if layout == "one rank, zero exterior":
            ext = torch.nn.functional.pad(x, (1, 1, h, h))
        else:
            ext = torch.cat([x[:1].expand(h, -1), x, x[-1:].expand(h, -1)])
            ext = torch.cat([ext[:, :1], ext, ext[:, -1:]], dim=1).contiguous()
        b = torch.nn.functional.pad(b, (1, 1, h, h))
    kw = dict(nxg=nxg, inv_dx2=2048.0 ** 2, inv_dy2=2048.0 ** 2, volp=2048.0 ** -2,
              sor=1.9, h=h, kb=kb)
    before = shard_rb_sweep.launches
    own, ss = shard_rb_sweep(ext, b, row0, **kw)
    assert shard_rb_sweep.launches == before + 1
    ref, ss_ref = shard_rb_sweep_plain(ext, b, row0, **kw)
    staged_before = _shard_rb_sweep_staged.launches
    st, ss_st = _shard_rb_sweep_staged(ext, b, row0, **kw)
    assert _shard_rb_sweep_staged.launches == staged_before + kb + 1
    torch.cuda.synchronize()
    assert own.shape == (rows, width)
    assert torch.equal(own, ref) and torch.equal(ss, ss_ref)
    assert torch.equal(own, st) and torch.equal(ss, ss_st)


@pytest.mark.cuda
@pytest.mark.parametrize("kb", range(1, 9))
@pytest.mark.parametrize("ot", [None, 32, 64])
def test_shard_fused_form_matches_staged_form(card, monkeypatch, kb, ot):
    """The fused form at kb 1-8 on odd band shapes (a 77-row band of a
    301-row grid, 45 and 131 columns, an interior and the last rank), on
    its own plan and on either tile side, against the staged form and the
    plain version: own rows and sum bit-equal."""
    from sr_for_cfd_tpu_torch.ops import shard_rb
    from sr_for_cfd_tpu_torch.parallel import spmd_kernels as sk

    g = np.random.default_rng(10 * kb + (ot or 0))
    h, rows, nxg = 2 * kb, 77, 301
    for width, row0 in ((45, 120), (131, nxg - rows)):
        ext, b = (torch.tensor(g.standard_normal((rows + 2 * h, width)), dtype=torch.float32,
                               device=card) for _ in range(2))
        kw = dict(nxg=nxg, inv_dx2=301.0 ** 2, inv_dy2=129.0 ** 2, volp=1.0 / (301 * 129),
                  sor=1.7, h=h, kb=kb)
        if ot is not None:  # the wrapper's cached plan, replaced for this call
            plan = shard_rb.shard_rb_plan(rows + 2 * h, width, h, kb, ot=ot)
            sk._fused_params.cache_clear()
            monkeypatch.setattr(shard_rb, "shard_rb_plan", lambda *a, **k: plan)
        own, ss = sk.shard_rb_sweep(ext, b, row0, **kw)
        if ot is not None:
            monkeypatch.undo()
            sk._fused_params.cache_clear()
        st, ss_st = sk._shard_rb_sweep_staged(ext, b, row0, **kw)
        ref, ss_ref = sk.shard_rb_sweep_plain(ext, b, row0, **kw)
        torch.cuda.synchronize()
        assert torch.equal(own, st) and torch.equal(ss, ss_st)
        assert torch.equal(own, ref) and torch.equal(ss, ss_ref)


def _shard_case(seed, rows, width, kb, nxg=301, row0=120):
    g = np.random.default_rng(seed)
    h = 2 * kb
    ext, b = (torch.tensor(g.standard_normal((rows + 2 * h, width)), dtype=torch.float32,
                           device="cuda") for _ in range(2))
    kw = dict(nxg=nxg, inv_dx2=301.0 ** 2, inv_dy2=129.0 ** 2, volp=1.0 / (301 * 129),
              sor=1.7, h=h, kb=kb)
    return ext, b, row0, kw


@pytest.mark.cuda
def test_shard_fused_survives_parameter_cache_turnover(card):
    """More call sites than the wrapper's cache of parameter blocks holds,
    then the first again, with no cache cleared: every call bit-equal to the
    staged form, and each call's `ss` its own (a later call on a block of
    the same shape leaves an earlier `ss` as it was)."""
    from sr_for_cfd_tpu_torch.parallel import spmd_kernels as sk

    n_sites = sk._fused_params.cache_info().maxsize + 6
    cases = [_shard_case(i, 20 + i % 7, 40 + i, 1 + i % 3) for i in range(n_sites)]
    results = [sk.shard_rb_sweep(ext, b, row0, **kw) for ext, b, row0, kw in cases]
    ext, b, row0, kw = cases[0]
    again = sk.shard_rb_sweep(ext, b, row0, **kw)
    # the same shape, other values: the first call's ss stays as it was
    other = sk.shard_rb_sweep(ext + 1.0, b, row0, **kw)
    staged = [sk._shard_rb_sweep_staged(ext, b, row0, **kw) for ext, b, row0, kw in cases]
    torch.cuda.synchronize()
    for (own, ss), (st, ss_st) in zip(results + [again], staged + staged[:1]):
        assert torch.equal(own, st) and torch.equal(ss, ss_st)
    assert not torch.equal(other[1], again[1])
    assert torch.equal(results[0][1], staged[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("kb", [33, 34])
def test_shard_sweep_past_the_fused_budget(card, kb):
    """kb 33 is the fused form's largest (one launch); kb 34 passes its
    shared memory and runs on the one-sweep form (kb + 1 launches): both
    bit-equal to the staged form and the plain version, as JAX's kernel
    takes any kb the halo buys."""
    from sr_for_cfd_tpu_torch.parallel import spmd_kernels as sk

    ext, b, row0, kw = _shard_case(kb, 40, 50, kb, nxg=400, row0=150)
    before = sk.shard_rb_sweep.launches
    own, ss = sk.shard_rb_sweep(ext, b, row0, **kw)
    assert sk.shard_rb_sweep.launches - before == (1 if kb == 33 else kb + 1)
    st, ss_st = sk._shard_rb_sweep_staged(ext, b, row0, **kw)
    ref, ss_ref = sk.shard_rb_sweep_plain(ext, b, row0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(own, st) and torch.equal(ss, ss_st)
    assert torch.equal(own, ref) and torch.equal(ss, ss_ref)


@pytest.mark.cuda
def test_shard_fused_refuses_a_plan_that_is_not_its_own(card):
    """A plan the C entry does not take (shared memory that does not match
    its tile and kb) is refused at the launch; nothing falls back."""
    from sr_for_cfd_tpu_torch.ops import kernel_lib, shard_rb

    lib = kernel_lib.load_library()
    ext = torch.zeros((40, 40), dtype=torch.float32, device=card)
    plan = shard_rb.shard_rb_plan(40, 40, 2, 1)
    scratch = [torch.zeros(plan.n_sum, device=card), torch.zeros(1, dtype=torch.int32,
                                                                  device=card)]
    big = plan._replace(smem=shard_rb.SMEM_BUDGET + 4)
    prm = shard_rb.make_params(big, 40, 40, nxg=36, h=2, mode=2, inv_dx2=1.0, inv_dy2=1.0,
                               volp=1.0, inv_ap=-0.25, partials=scratch[0].data_ptr(),
                               ticket=scratch[1].data_ptr())
    out = torch.empty((36, 40), device=card)
    import ctypes

    code = lib.srcfd_shard_rb_fused(ctypes.addressof(prm), ext.data_ptr(), out.data_ptr(),
                                    ext.data_ptr(), scratch[0].data_ptr(), 0,
                                    kernel_lib.stream_ptr(card))
    assert code != 0
    with pytest.raises(RuntimeError):
        kernel_lib.check(code, "shard_rb_fused")


@pytest.mark.cuda
def test_shard_wrapper_raises_on_what_the_kernel_does_not_take(card):
    from sr_for_cfd_tpu_torch.parallel.spmd_kernels import shard_rb_sweep

    kw = dict(nxg=64, inv_dx2=1.0, inv_dy2=1.0, volp=1.0, sor=1.5, h=2, kb=1)
    e64 = torch.zeros((12, 10), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="float32"):
        shard_rb_sweep(e64, e64, 0, **kw)
    et = torch.zeros((10, 12), dtype=torch.float32, device=card).T
    with pytest.raises(ValueError, match="contiguous"):
        shard_rb_sweep(et, et.contiguous(), 0, **kw)



def _mg_plan(card, nx, ny, lx, ly):
    from sr_for_cfd_tpu_torch.ops.mg_kernels import plan_hierarchy

    return plan_hierarchy(nx, ny, lx / nx, ly / ny, lx * ly / (nx * ny), 8, str(card))


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,lx,ly,max_cycles", [
    (400, 400, 10.0, 3.0, 3), (400, 400, 10.0, 3.0, 30), (33, 47, 1.0, 1.0, 30),
    (1001, 999, 1.0, 1.0, 3)])
def test_mg_cycle_forms_are_bit_equal(card, nx, ny, lx, ly, max_cycles):
    """The V-cycle as the solver runs it (tail + CUDA graph), its eager
    launches (tail, no graph) and the stage form (neither): bit-equal
    fields and equal cycle counts, over 3 forced cycles and over a solve
    that the stall policy ends (30 cycles at most); the BFS 400^2 grid, odd
    sizes with the whole hierarchy in the tail, and a grid with banded row
    transfers on the stages above the tail."""
    from sr_for_cfd_tpu_torch.ops.mg_kernels import _Cycle, _Tally, cycle_solve

    p, ff, geo = _problem(nx + ny, nx, ny, lx, ly, card)
    plan = _mg_plan(card, nx, ny, lx, ly)
    kw = dict(dt=geo["dt"], rho=geo["rho"], tol=1e-30, max_cycles=max_cycles)
    runs = {}
    for form, flags in (("graph", {}), ("eager", dict(_graph=False)),
                        ("stage", dict(_tail=False, _graph=False))):
        tally = _Tally()
        cyc = _Cycle(plan, card, 4, 4, 1.5, 40, counter=tally, **flags)
        before = tally.launches
        out, n = cycle_solve(cyc, p, ff, **kw)
        runs[form] = (out, n, tally.launches - before, tally.replays, cyc)
    out, n, launches, replays, cyc = runs["graph"]
    assert replays == n and launches == n * cyc.kernels
    assert runs["eager"][2] == launches  # the graph holds the eager launches
    assert runs["stage"][2] > launches
    for form in ("eager", "stage"):
        assert torch.equal(runs[form][0], out) and runs[form][1] == n
    if max_cycles == 3:
        assert n == 3
        ref, n_ref = mg_solve_pressure(p, ff, **dict(geo, tol=1e-30, max_cycles=3))
        _close(out, ref)


@pytest.mark.cuda
def test_level1_correction_forms_are_bit_equal(card):
    """The 2048^2 cavity's level-1 correction: the cached graph with the
    tail at (64, 64), its eager launches and the stage form, bit-equal;
    within 2e-5 of the plain version."""
    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk
    from sr_for_cfd_tpu_torch.ops.mg_kernels import _Cycle, _Tally

    n = 2048
    lv = sk.StreamLevels(n, n, 1.0 / n, 1.0 / n, 1.0 / n**2, card)
    g = np.random.default_rng(8)
    b1 = torch.tensor(g.standard_normal((lv.nc, lv.mc)), dtype=torch.float32,
                      device=card)
    assert lv.cycle.t == 5 and lv.setup.sizes[5] == (64, 64)
    e = sk.level1_correction(b1, lv).clone()
    for flags in (dict(_graph=False), dict(_tail=False, _graph=False)):
        cyc = _Cycle(lv.plan, card, 4, 4, lv.sor, 40, counter=_Tally(), top=1, **flags)
        assert torch.equal(cyc.correction(b1), e)
    _close(e, sk.level1_correction_plain(b1, lv))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["synchronize while capturing", "launch refused"])
def test_mg_failed_capture_raises(card, monkeypatch, fault):
    """A capture that fails, or a launch refused during it, raises from
    the solve; nothing falls back to eager launches or the plain
    version."""
    from sr_for_cfd_tpu_torch.ops import mg_kernels as mk

    body = mk._Cycle.body

    def faulty(self):
        capturing = torch.cuda.is_current_stream_capturing()
        if capturing and fault == "launch refused":
            # more shared memory than the kernel allows: the launch is refused
            self.tail_args = (*self.tail_args[:3], 2 * mk.TAIL_SMEM_BUDGET)
        body(self)
        if capturing and fault == "synchronize while capturing":
            torch.cuda.synchronize()

    monkeypatch.setattr(mk._Cycle, "body", faulty)
    p, ff, geo = _problem(5, 35, 45, 1.0, 1.0, card)
    mk.cached_cycle.cache_clear()
    with pytest.raises(RuntimeError):
        mg_solve_pressure_kernel(p, ff, **geo, tol=1e-30, max_cycles=3)
    monkeypatch.undo()
    torch.cuda.synchronize()
    out, n = mg_solve_pressure_kernel(p, ff, **geo, tol=1e-30, max_cycles=3)
    _close(out, mg_solve_pressure(p, ff, **geo, tol=1e-30, max_cycles=3)[0])


# ---- the fused momentum pass (rows 3 and 4) --------------------------------


def _mom_problem(card, nx, ny, seed):
    """A seeded row 4 problem on the card: (u, old interior, fluxes,
    keywords of tiled_solve_momentum)."""
    rng = np.random.default_rng(seed)
    u = torch.tensor(rng.standard_normal((nx + 2, ny + 2)) * 0.3, dtype=torch.float32,
                     device=card)
    v = torch.tensor(rng.standard_normal((nx + 2, ny + 2)) * 0.3, dtype=torch.float32,
                     device=card)
    old = u[1:-1, 1:-1] + torch.tensor(rng.standard_normal((nx, ny)) * 0.01,
                                       dtype=torch.float32, device=card)
    dx, dy = 1.0 / nx, 0.7 / ny
    return u, old, face_fluxes(u, v, dx, dy), dict(dx=dx, dy=dy, dt=1e-3, nu=0.01,
                                                   volp=dx * dy)


def _step_case(card, nx, ny, scheme="UPWIND", **settings):
    """A BFS fused-step solver on the card, seeded smooth state, and the
    design (b) stage object with its parameter block."""
    from sr_for_cfd_tpu_torch.ops import kernel_lib
    from sr_for_cfd_tpu_torch.ops import step_kernels as stk

    kw = dict(nx=nx, ny=ny, scheme=scheme, pressure_solver="multigrid",
              steps_per_kernel=1, **settings)
    solver = _fused_solver(make_bfs_solver, card, **kw)
    prm = stk.step_params(solver.case, True)
    u_in, below = stk._inlet(solver.profile, solver.state.u)
    nu = stk._nu_tensor(solver._nu, solver.state.u).reshape(1).contiguous()
    staged = stk._Staged(kernel_lib.load_library(), solver.case, prm, u_in, below, nu,
                         solver.state.u)
    return solver, staged, prm, nu


@pytest.mark.cuda
@pytest.mark.parametrize("row,nx,ny,scheme,k", [
    ("step", 400, 400, "UPWIND", 1),   # the north-star fine grid
    ("tiled", 2048, 2048, "QUICK", 3),  # the big grid
    ("tiled", 70, 45, "QUICK", 2),
    ("step", 61, 38, "QUICK", 3),
    ("tiled", 33, 130, "UPWIND", 13)])  # the largest k of UPWIND's plan but one
def test_mom_pass_matches_staged_form(card, row, nx, ny, scheme, k):
    """One fused pass against the staged form (2k half-sweep launches and
    the finalize): field and rms bit-equal, with the old field
    interior-shaped (row 4) or padded (row 3)."""
    from sr_for_cfd_tpu_torch.ops import mom_pass
    from sr_for_cfd_tpu_torch.ops.momentum_kernels import _coefficients

    quick = scheme == "QUICK"
    if row == "tiled":
        f0, old, ff, kw = _mom_problem(card, nx, ny, nx + k)
        nu = torch.full((1,), kw["nu"], dtype=torch.float32, device=card)
        coef = mom_pass.Coef(kw["volp"], kw["volp"] / kw["dt"],
                             *_coefficients(kw["dx"], kw["dy"], kw["volp"]))
        prm = None
    else:
        solver, _, prm, nu = _step_case(card, nx, ny, scheme, momentum_check_every=k)
        f0 = old = solver.state.u
        ff = solver.state.ff
        coef = mom_pass.Coef(prm.volp, prm.volp_dt, prm.inv_dx2, prm.inv_dy2, prm.ap_d)
    staged = mom_pass.StagedPass(f0, old, ff, nu, k, quick, coef, prm)
    ref = f0.clone()
    staged(ref)
    one = mom_pass.OnePass(nx + 2, ny + 2, card, quick=quick, k=k,
                           old_padded=prm is not None, coef=coef)
    out = torch.full_like(f0, float("nan"))
    one(f0, out, old, ff, nu)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(one.rms, staged.rms)


@pytest.mark.cuda
def test_tiled_momentum_device_exit_matches_host_exit(card):
    """Row 4's loop (QUICK, 3 sweeps a pass, batches of 2) against the
    host-exit loop on a 130x97 grid: bit-equal fields and equal counts with
    the exit by max_iter at every position of a batch, by the tolerance,
    and by the stall policy (tol 0 on a 14x12 grid)."""
    from sr_for_cfd_tpu_torch.ops import momentum_kernels as mk

    for nx, ny, tols, iters in ((130, 97, (0.0, 1e-3), range(1, 3 * 2 * mk.BATCH + 2)),
                                (14, 12, (0.0,), (30000,))):
        u, old, ff, kw = _mom_problem(card, nx, ny, nx)
        for tol in tols:
            for max_iter in (iters if tol == 0.0 else (300,)):
                args = dict(kw, scheme="QUICK", tol=tol, max_iter=max_iter, check_every=3,
                            return_count=True)
                out, n = mk.tiled_solve_momentum(u, old, ff, **args)
                ref, n_ref = mk.tiled_solve_momentum(u, old, ff, _staged=True, **args)
                torch.cuda.synchronize()
                assert n == n_ref and torch.equal(out, ref), (nx, tol, max_iter)
                if nx == 14:
                    assert n < max_iter  # the stall policy ended it
                elif tol == 0.0:
                    assert n == 3 * -(-max_iter // 3)


@pytest.mark.cuda
def test_step_momentum_device_exit_matches_host_exit(card):
    """Row 3's loop (the test on the best rms, batches of BATCH) against
    the host-exit loop on a 64x48 BFS grid at dt 0.1 (the rms falls from
    1.9e-2 to 1.2e-8 in 16 sweeps, a new best at each): bit-equal fields
    and equal counts with the exit by max_iter at every position of two
    batches, and at a tolerance."""
    from dataclasses import replace

    from sr_for_cfd_tpu_torch.ops import step_kernels as stk

    solver, _, prm, nu = _step_case(card, 64, 48, dt=0.1)
    s = solver.state
    for m, tol in [(m, 0.0) for m in range(1, 2 * stk.BATCH + 2)] + [(200, 1e-4)]:
        case = replace(solver.case, settings=replace(solver.case.settings,
                                                     inner_max_iter=m, inner_tolerance=tol))
        st = stk._Staged(stk.kernel_lib.load_library(), case, prm, *stk._inlet(
            solver.profile, s.u), nu, s.u)
        out, n = st.momentum(s.u, s.ff)
        ref, n_ref = st.momentum_host_exit(s.u, s.ff)
        torch.cuda.synchronize()
        assert n == n_ref and torch.equal(out, ref), (m, tol)
        assert n == m if tol == 0.0 else n < m


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["b_cavity64_quick_k2", "b_bfs40_multigrid_k2"])
def test_design_b_step_matches_its_staged_form(card, name):
    """Design (b) (momentum on the fused pass's device-exit loop, the
    folded stages) against its staged form: every output bit-equal, equal
    counts, fewer momentum host reads."""
    _, make, kw = FUSED[name]
    solver = _fused_solver(make, card, **kw)
    s = solver.state
    args = (s.u, s.v, s.p, s.ff, solver.case, solver.profile)
    reads = simple_step_kernel.reads
    out = simple_step_kernel(*args, nu=solver._nu, _design="b")
    reads = simple_step_kernel.reads - reads
    staged_reads = simple_step_kernel.reads
    ref = simple_step_kernel(*args, nu=solver._nu, _design="b", _staged=True)
    staged_reads = simple_step_kernel.reads - staged_reads
    torch.cuda.synchronize()
    for a, b in zip((*out[:3], *out[3], out[4]), (*ref[:3], *ref[3], ref[4])):
        assert torch.equal(a, b)
    assert out[5] == ref[5] and reads < staged_reads


@pytest.mark.cuda
def test_momentum_past_the_fused_budget(card):
    """A k whose tile passes the fused pass's shared memory runs on the
    staged form, as JAX runs it: row 4 at QUICK k = 14 (29 launches a
    pass) and design (b) with momentum_check_every = 15 (UPWIND), against
    the plain versions."""
    from sr_for_cfd_tpu_torch.ops import mom_pass
    from sr_for_cfd_tpu_torch.ops import momentum_kernels as mk

    assert not mom_pass.fits(14, True) and not mom_pass.fits(15, False)
    u, old, ff, kw = _mom_problem(card, 64, 60, 14)
    args = dict(kw, scheme="QUICK", tol=0.0, max_iter=28, check_every=14)
    before = mk.tiled_solve_momentum.launches
    out, n = mk.tiled_solve_momentum(u, old, ff, return_count=True, **args)
    assert mk.tiled_solve_momentum.launches - before == 2 * 29
    ref, n_ref = mk.tiled_solve_momentum_plain(u, old, ff, **args)
    _close(out, ref)
    assert n == n_ref == 28
    solver = _fused_solver(make_bfs_solver, card, nx=40, ny=30, scheme="UPWIND",
                           pressure_solver="multigrid", steps_per_kernel=1,
                           inner_tolerance=1e-3, momentum_check_every=15)
    s = solver.state
    step_args = (s.u, s.v, s.p, s.ff, solver.case, solver.profile)
    out = simple_step_kernel(*step_args, nu=solver._nu, _design="b")
    ref = simple_step_plain(*step_args, nu=solver._nu)
    for a, b in zip((*out[:3], *out[3]), (*ref[:3], *ref[3])):
        _close(a, b)
    assert out[5] == ref[5]


@pytest.mark.cuda
def test_momentum_loop_cache_survives_turnover(card):
    """More settings than the loop cache holds, then the first again, with
    no cache cleared: every solve bit-equal to the host-exit loop, and each
    cached loop's parameter block points at its own partials, ticket and
    state."""
    from sr_for_cfd_tpu_torch.ops import mom_pass
    from sr_for_cfd_tpu_torch.ops import momentum_kernels as mk

    n_settings = mom_pass.cached_loop.cache_info().maxsize + 3
    cases = [(40 + 3 * i, 30 + i, 1e-3 * (1 + i % 3)) for i in range(n_settings)]
    for nx, ny, tol in cases + cases[:1]:
        u, old, ff, kw = _mom_problem(card, nx, ny, nx + ny)
        args = dict(kw, scheme="QUICK", tol=tol, max_iter=60, check_every=3,
                    return_count=True)
        out, n = mk.tiled_solve_momentum(u, old, ff, **args)
        ref, n_ref = mk.tiled_solve_momentum(u, old, ff, _staged=True, **args)
        torch.cuda.synchronize()
        assert n == n_ref and torch.equal(out, ref), (nx, ny)
    assert mom_pass.cached_loop.cache_info().currsize == mom_pass.cached_loop.cache_info().maxsize


def _stream_level(nx, ny, lx, ly, n, seed, device):
    """A streamed hierarchy with n_pre = n_post = n and seeded x, b and the
    level-1 correction e."""
    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk

    lv = sk.StreamLevels(nx, ny, lx / nx, ly / ny, (lx / nx) * (ly / ny), device,
                         n_pre=n, n_post=n)
    g = np.random.default_rng(seed)

    def field(rows):
        return torch.tensor(g.standard_normal((rows, lv.mf)), dtype=torch.float32,
                            device=device)

    return lv, field(lv.nf), field(lv.nf), field(lv.nc if lv.coarsen_x else lv.nf)


# (nx, ny, lx, ly, coarsen_x, coarsen_y): the big grid, the 48^2 forced-slab
# cavity's, a semi-coarsened hierarchy each way, a ragged level (sides
# multiples of neither the 32-row strip nor the 96-column strip, nor 32)
STREAM_SHAPES = [(2048, 2048, 1.0, 1.0, True, True), (48, 48, 1.0, 1.0, True, True),
                 (1024, 1024, 10.0, 3.0, False, True), (1024, 1024, 3.0, 10.0, True, False),
                 (1030, 1542, 1.0, 1.0, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shape", STREAM_SHAPES, ids=lambda s: "%dx%d_%g_%g" % s[:4])
def test_stream_fused_passes_match_staged(card, shape, n):
    """Each fused pass in one launch, bit-equal to its staged form: pass A's
    x, level-1 right-hand side and entry rms, pass B's x."""
    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk

    nx, ny, lx, ly, cx, cy = shape
    lv, x, b, e = _stream_level(nx, ny, lx, ly, n, nx + ny + n, card)
    assert (lv.coarsen_x, lv.coarsen_y) == (cx, cy)
    before = (sk.stream_pass_a.launches, sk.stream_pass_b.launches)
    ya, b1, rms = sk.stream_pass_a(x, b, lv)
    yb = sk.stream_pass_b(x, b, e, lv)
    assert (sk.stream_pass_a.launches - before[0], sk.stream_pass_b.launches - before[1]) \
        == (1, 1)
    sa = sk.stream_pass_a_staged(x, b, lv, counter=_Tally())
    sb = sk.stream_pass_b_staged(x.clone(), b, e, lv, counter=_Tally())
    torch.cuda.synchronize()
    assert torch.equal(ya, sa[0]) and torch.equal(b1, sa[1]) and torch.equal(rms, sa[2])
    assert torch.equal(yb, sb)


@pytest.mark.cuda
@pytest.mark.parametrize("pass_", ["a", "b"])
def test_stream_pass_past_the_fused_budget(card, pass_):
    """The first n past the fused kernel's halo (8 for pass A, 9 for pass
    B) runs on the staged form: 2n + 3 and 2n + 1 launches, its bits, and
    within 2e-5 of the plain version."""
    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk

    n = 8 if pass_ == "a" else 9
    lv, x, b, e = _stream_level(96, 80, 1.0, 1.0, n, 17, card)
    counter = sk.stream_pass_a if pass_ == "a" else sk.stream_pass_b
    before = counter.launches
    if pass_ == "a":
        out = sk.stream_pass_a(x, b, lv)
        ref = sk.stream_pass_a_staged(x, b, lv, counter=_Tally())
        plain = sk.stream_pass_a_plain(x, b, lv)
    else:
        out = (sk.stream_pass_b(x.clone(), b, e, lv),)
        ref = (sk.stream_pass_b_staged(x.clone(), b, e, lv, counter=_Tally()),)
        plain = (sk.stream_pass_b_plain(x, b, e, lv),)
    assert counter.launches - before == 2 * n + (3 if pass_ == "a" else 1)
    for o, r, p in zip(out, ref, plain):
        assert torch.equal(o, r)
        _close(o, p.reshape(o.shape))


@pytest.mark.cuda
def test_stream_fused_survives_parameter_cache_turnover(card):
    """More streamed settings than `stream_levels` caches (each with its
    fused passes' parameter blocks), then the first again after the cache
    let it go and the memory was reused: every call bit-equal to the staged
    form."""
    import gc

    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk

    sizes = [(40 + 2 * i, 36 + 4 * i) for i in range(sk.stream_levels.cache_info().maxsize + 3)]

    def run(nx, ny):
        lv = sk.stream_levels(nx, ny, 1.0 / nx, 1.0 / ny, 1.0 / (nx * ny), str(card), 4, 4,
                              sk.MG_SMOOTHER_SOR, 8, 40)
        g = np.random.default_rng(nx * ny)
        x, b = (torch.tensor(g.standard_normal((nx, ny)), dtype=torch.float32, device=card)
                for _ in range(2))
        out = sk.stream_pass_a(x, b, lv)
        ref = sk.stream_pass_a_staged(x, b, lv, counter=_Tally())
        return out, ref

    first = run(*sizes[0])
    for s in sizes[1:]:
        run(*s)
    gc.collect()
    junk = [torch.full((4096,), 7.0, device=card) for _ in range(64)]
    again = run(*sizes[0])
    torch.cuda.synchronize()
    for out, ref in (first, again):
        assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert all(torch.equal(o, r) for o, r in zip(first[0], again[0]))
    del junk


@pytest.mark.cuda
def test_stream_fused_refuses_a_plan_that_is_not_its_own(card):
    """A parameter block the C entry does not take (shared memory that is not
    its plan's, an n past its halo) is refused at the launch."""
    from sr_for_cfd_tpu_torch.ops import kernel_lib
    from sr_for_cfd_tpu_torch.ops import stream_pass as sp

    lv, x, b, e = _stream_level(64, 64, 1.0, 1.0, 2, 3, card)
    fused = sp.FusedPass(lv, "b")
    y = torch.empty_like(x)
    assert fused(x, y, b, e=e) == 0
    for field, value in (("smem", fused.params.smem + 16), ("n", sp.MAX_N["b"] + 1)):
        old = getattr(fused.params, field)
        setattr(fused.params, field, value)
        code = fused(x, y, b, e=e)
        setattr(fused.params, field, old)
        assert code != 0
        with pytest.raises(RuntimeError):
            kernel_lib.check(code, "stream_pass")


@pytest.mark.cuda
def test_stream_wrappers_raise_on_what_the_fused_passes_do_not_take(card):
    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk

    lv, x, b, e = _stream_level(64, 64, 1.0, 1.0, 2, 4, card)
    wide = torch.zeros((64, 66), dtype=torch.float32, device=card)
    with pytest.raises(ValueError):
        sk.stream_pass_a(wide[:, :64], b, lv)  # not contiguous
    with pytest.raises(ValueError):
        sk.stream_pass_b(x, b.double(), e, lv)
    with pytest.raises(ValueError):
        sk.stream_pass_b(x, b, e[:-2].contiguous(), lv)


# ---- row 3, design (a) over a case axis (the sweep's batched launch) -------


def _case_batch(card, n_side, k, reynolds, seeded=True):
    """The sweep's stacked state: one double-lid QUICK cavity per Reynolds
    number (dt 1e-3, float32, K steps a launch), each warm-started from
    its own seeded field; returns (solver of the first case, u, v, p, ff,
    nu)."""
    from sr_for_cfd_tpu_torch.ops.stencil import FaceFluxes

    states = []
    for i, re in enumerate(reynolds):
        s = make_cavity_solver(Re=re, nx=n_side, ny=n_side, dt=1e-3, scheme="QUICK",
                               double_lid=True, dtype="float32", fused_step=True,
                               steps_per_kernel=k, chunk_size=k, device=card)
        if seeded:
            g = np.random.default_rng(1000 + i)
            s.warm_start({c: g.standard_normal((n_side, n_side)) * 0.1 for c in "uvp"})
        states.append(s)
    st = [s.state for s in states]
    u, v, p = (torch.stack([getattr(x, c) for x in st]).contiguous() for c in "uvp")
    ff = FaceFluxes(*(torch.stack([x.ff[i] for x in st]).contiguous() for i in range(4)))
    nu = torch.tensor([1.0 / re for re in reynolds], dtype=torch.float32, device=card)
    return states[0], u, v, p, ff, nu


@pytest.mark.cuda
@pytest.mark.parametrize("n_side,k", [(10, 50), (50, 4)])
def test_batched_step_is_bit_equal_to_single_launches(card, n_side, k):
    """Eight cases (Re 100..800), one masked out: each listed case's fields,
    fluxes, res and counts bit-equal to its own single design (a) launch;
    the masked case's inputs come back unchanged, its res and counts 0;
    one launch counted."""
    from sr_for_cfd_tpu_torch.ops.step_kernels import simple_step_small_batched

    re_list = list(range(100, 801, 100))
    s0, u, v, p, ff, nu = _case_batch(card, n_side, k, re_list)
    masked = 5
    listed = [b for b in range(8) if b != masked]
    before = (simple_step_small_batched.launches, simple_step_kernel.launches,
              simple_step_kernel.calls)
    out = simple_step_small_batched(u, v, p, ff, s0.case, s0.profile, nu, listed)
    torch.cuda.synchronize()
    assert (simple_step_small_batched.launches - before[0],
            simple_step_kernel.launches - before[1],
            simple_step_kernel.calls - before[2]) == (1, 1, 1)
    for b in listed:
        one = simple_step_kernel(u[b], v[b], p[b], type(ff)(*(t[b] for t in ff)),
                                 s0.case, s0.profile, nu=nu[b], _design="a")
        for got, want in zip((*out[:3], *out[3]), (*one[:3], *one[3])):
            assert torch.equal(got[b], want)
        assert torch.equal(out[4][b], one[4])
        assert out[5][b].tolist() == one[5]
        ref = simple_step_plain(u[b], v[b], p[b], type(ff)(*(t[b] for t in ff)),
                                s0.case, s0.profile, nu=nu[b])
        for got, want in zip((*out[:3], *out[3]), (*ref[:3], *ref[3])):
            _close(got[b], want)
        assert out[5][b].tolist() == ref[5]
    for got, want in zip((*out[:3], *out[3]), (u, v, p, *ff)):
        assert torch.equal(got[masked], want[masked])
    assert not out[4][masked].any() and not out[5][masked].any()


@pytest.mark.cuda
def test_batched_step_empty_and_wide_case_lists(card):
    """An empty list launches nothing and returns the inputs; 140 cases
    (more than the card's 132 SMs) are each bit-equal to their single
    launch."""
    from sr_for_cfd_tpu_torch.ops.step_kernels import simple_step_small_batched

    re_list = [100.0 + 5.0 * i for i in range(140)]
    s0, u, v, p, ff, nu = _case_batch(card, 10, 4, re_list, seeded=False)
    before = simple_step_small_batched.launches
    out = simple_step_small_batched(u, v, p, ff, s0.case, s0.profile, nu, [])
    assert simple_step_small_batched.launches == before
    for got, want in zip((*out[:3], *out[3]), (u, v, p, *ff)):
        assert torch.equal(got, want)
    out = simple_step_small_batched(u, v, p, ff, s0.case, s0.profile, nu, range(140))
    for b in range(140):
        one = simple_step_kernel(u[b], v[b], p[b], type(ff)(*(t[b] for t in ff)),
                                 s0.case, s0.profile, nu=nu[b], _design="a")
        for got, want in zip((*out[:3], *out[3]), (*one[:3], *one[3])):
            assert torch.equal(got[b], want)
        assert torch.equal(out[4][b], one[4]) and out[5][b].tolist() == one[5]


@pytest.mark.cuda
def test_batched_step_fit_rule_matches_the_library(card):
    """The Python twin of srcfd_step_small_fits routes the sweep on the CPU;
    it must agree with the C rule."""
    from sr_for_cfd_tpu_torch.ops import kernel_lib
    from sr_for_cfd_tpu_torch.ops.step_kernels import small_fits

    lib = kernel_lib.load_library()
    for nx2 in range(3, 140, 7):
        for ny2 in range(3, 140, 5):
            assert small_fits(nx2, ny2) == bool(lib.srcfd_step_small_fits(nx2, ny2))


@pytest.mark.cuda
def test_batched_step_raises_on_what_the_kernel_does_not_take(card):
    from sr_for_cfd_tpu_torch.ops.step_kernels import simple_step_small_batched

    s0, u, v, p, ff, nu = _case_batch(card, 10, 1, [100, 200])
    rest = (s0.case, s0.profile, nu)
    with pytest.raises(ValueError, match="indices"):
        simple_step_small_batched(u, v, p, ff, *rest, [0, 2])
    with pytest.raises(ValueError, match="indices"):
        simple_step_small_batched(u, v, p, ff, *rest, [1, 1])
    with pytest.raises(ValueError, match="float32"):
        simple_step_small_batched(u.double(), v, p, ff, *rest, [0])
    big = _case_batch(card, 80, 1, [100])
    with pytest.raises(ValueError, match="design"):
        simple_step_small_batched(*big[1:5], big[0].case, big[0].profile, big[5], [0])


@pytest.mark.cuda
def test_training_step_on_the_card_matches_the_cpu(card):
    """One MSE + Adam step of the 10 -> 400 autoencoder on the card and on
    the CPU from the same weights, Adam moments (3 steps first) and batch,
    TF32 off: the loss within 1e-4 relative, the weights within 1e-5 of
    the largest |weight|."""
    import copy

    from sr_for_cfd_tpu_torch.sr.inference import SRModel, _no_tf32
    from sr_for_cfd_tpu_torch.workflow import training as tr

    module = SRModel.create(10, 400, rng_seed=3, device=card).module
    g = np.random.default_rng(4)
    x = torch.tensor(g.standard_normal((8, 10, 10, 1)), dtype=torch.float32, device=card)
    y = torch.tensor(g.standard_normal((8, 400, 400, 1)), dtype=torch.float32, device=card)
    opt = tr.Adam(list(module.parameters()))
    with _no_tf32():
        for _ in range(3):
            tr.train_step(module, opt, x, y)
        out = {}
        for on in ("cpu", card):
            m = copy.deepcopy(module).to(on)
            loss = tr.train_step(m, opt.to(on), x.to(on), y.to(on))
            out[str(on)] = (float(loss), [p.detach().cpu() for p in m.parameters()])
    (lc, pc), (lg, pg) = out["cpu"], out[str(card)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    scale = max(float(p.abs().max()) for p in pc)
    assert max(float((a - b).abs().max()) for a, b in zip(pg, pc)) <= 1e-5 * scale


@pytest.mark.cuda
def test_native_dat_writer_on_the_card_machine(card, tmp_path):
    """The card's machine builds the native .dat writer (its CUDA toolkit
    brings a host compiler); a 400^2 field's file is the Python writer's,
    byte for byte."""
    from sr_for_cfd_tpu_torch.config import MeshParameters
    from sr_for_cfd_tpu_torch.io import datfiles, native_io

    assert native_io.unavailable() is None
    var = np.random.default_rng(40).standard_normal((3, 402, 402))
    mesh = MeshParameters(nx=400, ny=400)
    before = native_io.used["native"]
    datfiles.save_full_field(str(tmp_path / "n.dat"), var, mesh, 400.0, 2e-3)
    assert native_io.used["native"] == before + 1
    datfiles.save_full_field_python(str(tmp_path / "p.dat"), var, mesh, 400.0, 2e-3)
    assert (tmp_path / "n.dat").read_bytes() == (tmp_path / "p.dat").read_bytes()


@pytest.fixture
def one_rank_nccl(card, tmp_path):
    """A one-rank NCCL world for the row-decomposed solver (none joined
    before)."""
    import os

    import torch.distributed as dist

    from sr_for_cfd_tpu_torch.parallel import mesh

    if dist.is_initialized():
        pytest.skip("a process group is joined already")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh.init_single_rank(card, str(tmp_path))
    yield card
    dist.destroy_process_group()


@pytest.mark.cuda
def test_adapter_solve_is_bit_equal_to_the_bare_solver(one_rank_nccl):
    """SpmdWorkflowAdapter (precompile, warm start, solve) on one rank: the
    64^2 BFS on the sharded V-cycle with row 9 as its smoother, bit-equal
    to the same SpmdSolver driven bare, with equal counts."""
    from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh
    from sr_for_cfd_tpu_torch.parallel.spmd_kernels import shard_rb_sweep
    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver, SpmdWorkflowAdapter

    torch.backends.cuda.matmul.allow_tf32 = False
    case = make_bfs_solver(Re=400, nx=64, ny=64, dt=2e-3, scheme="UPWIND", dtype="float32",
                           use_pallas=True, pressure_solver="multigrid", max_iterations=20,
                           device=one_rank_nccl).case
    rng = np.random.default_rng(64)
    warm = {c: rng.standard_normal((64, 64)) * 0.05 for c in "uvp"}
    adapter = SpmdWorkflowAdapter(SpmdSolver(case, make_mesh(1, "x"), device=one_rank_nccl))
    adapter.warm_start(warm)
    assert adapter.precompile() > 0.0
    before = shard_rb_sweep.launches
    iterations, _ = adapter.solve("unused", verbose=False, save_results=False)
    assert shard_rb_sweep.launches > before
    bare = SpmdSolver(case, make_mesh(1, "x"), device=one_rank_nccl)
    bare.warm_start(warm)
    bare.solve()
    assert iterations == bare.local.count == 20
    assert adapter.spmd.inner_counts == bare.inner_counts
    got, want = adapter.interior_fields(), bare.interior_fields()
    for c in "uvp":
        np.testing.assert_array_equal(got[c], want[c])
