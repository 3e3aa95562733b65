"""The fused momentum pass (`csrc/mom_pass.cu`) and the device-exit momentum
loops (`ops/mom_pass.py`, `ops/exit_loop.py`), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
Here:
- the plan at the main paths' shapes (the 402x402 north-star fine grid,
  UPWIND, k = 1; the 2050x2050 big grid, QUICK, k = 3) and at ragged ones:
  the shared memory under the budget, output tiles that are whole 32 x 8
  blocks of the staged half-sweep's grid; the largest k with a plan; the C
  constants and the parameter block's layout read from the source;
- `pass_twin`, a plain transcription of the kernel's schedule (per tile:
  the field loaded with its halo, zero outside the field; the k sweeps on
  rings that shrink per half-sweep, each cell's residual taken from the
  tile's data only; the tile written out; one red and one black partial
  per 32 x 8 block in its thread order; the last block's fixed-order sum):
  field bit-equal in float32 to `tiled_solve_momentum_plain` and to the
  fused step's plain momentum loop, the sum equal to the staged form's
  (its partials summed as `srcfd_rms_finalize` sums them), for QUICK and
  UPWIND, k = 1, 2 and 3, grids whose padded sides are not multiples of
  the tile;
- `exit_state_step` with k sweeps a launch and the test on the rms or on
  the best rms, against the host loops' policy over seeded rms sequences
  (tolerance, stall, NaN, max_iter);
- `MomentumLoop` driven on CPU tensors with a stub in place of the kernel
  library, whose pass runs `pass_twin` and the state step: field bits and
  sweep counts equal to the host loops' (`tiled_solve_momentum_plain`; the
  fused step's `_plain_momentum`, whose test is on the best rms) with the
  exit by max_iter at every position of a batch, by the tolerance and by
  the stall policy, and one host read per batch;
- one parity case per row against JAX on the same numpy-seeded inputs: the
  stubbed loop against `pallas_momentum.tiled_solve_momentum` in interpret
  mode (row 4), and the plain whole step with its momentum loops on the
  stubbed loop against `pallas_step.pallas_simple_step` (row 3), with the
  tolerances of tests/test_torch_momentum.py and tests/test_torch_step.py.
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu_torch.ops import exit_loop, kernel_lib, mom_pass
from sr_for_cfd_tpu_torch.ops import momentum_kernels as mk
from sr_for_cfd_tpu_torch.ops import step_kernels as sk
from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes
from sr_for_cfd_tpu_torch.ops.sweeps import checkerboard, stall_update, stalled
from sr_for_cfd_tpu_torch.parallel.spmd_kernels import _fixed_sum

torch.set_num_threads(1)

SRC = Path(mom_pass.__file__).parent.parent / "csrc" / "mom_pass.cu"


def test_constants_and_parameter_block_are_the_kernel_source():
    src = SRC.read_text()
    budget = re.search(r"#define MOM_PASS_SMEM_BUDGET \((\d+) \* 1024\)", src)
    assert int(budget.group(1)) * 1024 == mom_pass.SMEM_BUDGET
    sums = int(re.search(r"#define MOM_SUMS (\d+)", src).group(1))
    assert sums == mom_pass.MOM_SUMS
    # the static sums and the ticket flag fit beside the budget in the
    # 227 KB a block can have
    assert mom_pass.SMEM_BUDGET + 4 * sums * 256 + 4 <= 232448
    body = re.search(r"struct MomPassParams \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        words = decl.replace(",", " ").split()
        if not words:
            continue
        kind = {"float*": ctypes.c_void_p, "unsigned*": ctypes.c_void_p,
                "TiledState*": ctypes.c_void_p, "int": ctypes.c_int,
                "float": ctypes.c_float}[words[0]]
        fields += [(name, kind) for name in words[1:]]
    assert fields == mom_pass.Params._fields_
    assert ctypes.sizeof(mom_pass.Params) == 128


# (nx2, ny2, k, quick) of the main paths, then ragged ones
MAIN = [(402, 402, 1, False), (2050, 2050, 3, True)]
RAGGED = [(72, 47, 1, True), (61, 38, 3, False), (130, 99, 2, True)]


@pytest.mark.parametrize("shape", MAIN + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_plan_of_the_main_path_shapes(shape):
    nx2, ny2, k, quick = shape
    plan = mom_pass.mom_plan(nx2, ny2, k, quick)
    assert plan.halo == 2 * k + quick
    assert plan.smem == mom_pass.smem_bytes(k, quick) <= mom_pass.SMEM_BUDGET
    # tiles cover the padded field and are whole 32 x 8 staged blocks
    assert plan.ot == mom_pass.TILE and plan.ot % 32 == 0 and plan.ot % 8 == 0
    assert plan.tiles_x * plan.ot >= ny2 > (plan.tiles_x - 1) * plan.ot
    assert plan.tiles_y * plan.ot >= nx2 > (plan.tiles_y - 1) * plan.ot
    # the staged form's partials: srcfd_grid(nx2, ny2)
    assert (plan.gx, plan.gy) == (math.ceil(ny2 / 32), math.ceil(nx2 / 8))
    if shape == MAIN[0]:
        assert plan.n_tiles == 169 and plan.smem == 40384
    if shape == MAIN[1]:
        assert plan.n_tiles == 65 * 65 and plan.smem == 63344


def test_plan_refusals_and_the_largest_k():
    """k 13 (QUICK) and 14 (UPWIND) are the largest with a plan; a larger
    k runs on the staged form (card tests)."""
    assert [k for k in range(1, 40) if mom_pass.fits(k, True)] == list(range(1, 14))
    assert [k for k in range(1, 40) if mom_pass.fits(k, False)] == list(range(1, 15))
    with pytest.raises(ValueError, match="budget"):
        mom_pass.mom_plan(402, 402, 14, True)
    with pytest.raises(ValueError):
        mom_pass.mom_plan(402, 402, 0, True)
    assert mom_pass.mom_plan(402, 402, 13, True).smem <= mom_pass.SMEM_BUDGET


def _view(ptr, shape, ctype=ctypes.c_float):
    """A CPU tensor over the memory at `ptr` (what the kernel is given)."""
    n = int(np.prod(shape))
    return torch.from_numpy(np.ctypeslib.as_array((ctype * n).from_address(ptr))
                            .reshape(shape))


def _block_partials(terms, plan):
    """(gy, gx) per-32 x 8-block sums of a padded array of terms in the
    staged block's thread order (thread t: cell (t // 32, t % 32))."""
    nx2, ny2 = terms.shape
    t = torch.zeros((plan.gy * 8, plan.gx * 32), dtype=terms.dtype)
    t[:nx2, :ny2] = terms
    blocks = t.reshape(plan.gy, 8, plan.gx, 32).permute(0, 2, 1, 3).reshape(-1, 256)
    return _fixed_sum(blocks)


def pass_twin(f0, residual, plan):
    """The fused pass's schedule in plain PyTorch: (field, sum of r^2).
    `residual(f)` gives (r, ap) on the interior of a padded field; each
    tile's cells take it from a field that holds the tile's loaded data and
    zeros elsewhere, so a halo too narrow would change their bits."""
    nx2, ny2 = f0.shape
    nx, ny = nx2 - 2, ny2 - 2
    k, H, ot = plan.k, plan.halo, plan.ot
    L = ot + 2 * H
    out = torch.full_like(f0, float("nan"))
    red_t, black_t = torch.zeros_like(f0), torch.zeros_like(f0)
    li = torch.arange(L)[:, None]
    lj = torch.arange(L)[None, :]
    for ta in range(plan.tiles_y):
        for tb in range(plan.tiles_x):
            ii, jj = ta * ot - H + li, tb * ot - H + lj
            inside = (ii >= 0) & (ii < nx2) & (jj >= 0) & (jj < ny2)
            ic, jc = ii.clamp(0, nx2 - 1).expand(L, L), jj.clamp(0, ny2 - 1).expand(L, L)
            sf = torch.where(inside, f0[ic, jc], 0.0)
            interior = (ii >= 1) & (ii <= nx) & (jj >= 1) & (jj <= ny)
            colour = (ii + jj) % 2
            tile = (li >= H) & (li < H + ot) & (lj >= H) & (lj < H + ot)
            terms = torch.zeros((L, L))
            for s in range(k):
                for half in (0, 1):
                    d = 2 * (k - 1 - s) + 1 - half
                    region = ((li >= H - d) & (li < H + ot + d) & (lj >= H - d)
                              & (lj < H + ot + d))
                    mask = region & interior & (colour == half)
                    g = torch.zeros_like(f0)
                    g[ic[inside], jc[inside]] = sf[inside]
                    r, ap = residual(g)
                    ri = (ic - 1).clamp(0, nx - 1), (jc - 1).clamp(0, ny - 1)
                    inc = torch.where(interior, r[ri] / ap[ri], 0.0)
                    sf = torch.where(mask, sf + inc, sf)
                    if s == k - 1:
                        terms = torch.where(mask & tile, r[ri] * r[ri], terms)
            keep = tile & inside
            out[ii.expand(L, L)[keep], jj.expand(L, L)[keep]] = sf[keep]
            cells = (ii.expand(L, L)[keep], jj.expand(L, L)[keep])
            red_t[cells] = torch.where(colour[keep] == 0, terms[keep], 0.0)
            black_t[cells] = torch.where(colour[keep] == 1, terms[keep], 0.0)
    partials = torch.cat([_block_partials(red_t, plan), _block_partials(black_t, plan)])
    return out, _fixed_sum(partials[None])[0]


def staged_sum(f, residual, plan):
    """The staged form's sum over one sweep from f: r1^2 on red interior
    cells, then r2^2 on black ones after the red update, each colour's
    partials per 32 x 8 block, all red then all black in
    srcfd_fixed_sum's order."""
    nx, ny = f.shape[0] - 2, f.shape[1] - 2
    red = checkerboard(nx, ny)
    r1, ap1 = residual(f)
    g = f.clone()
    g[1:-1, 1:-1] += torch.where(red, r1 / ap1, 0.0)
    r2, _ = residual(g)
    red_t, black_t = torch.zeros_like(f), torch.zeros_like(f)
    red_t[1:-1, 1:-1] = torch.where(red, r1 * r1, 0.0)
    black_t[1:-1, 1:-1] = torch.where(red, 0.0, r2 * r2)
    partials = torch.cat([_block_partials(red_t, plan), _block_partials(black_t, plan)])
    return _fixed_sum(partials[None])[0]


def _row4_problem(nx, ny, seed):
    """A seeded row 4 problem: (u, old interior, fluxes, solver keywords)."""
    g = np.random.default_rng(seed)
    u = torch.tensor(g.standard_normal((nx + 2, ny + 2)) * 0.3, dtype=torch.float32)
    v = torch.tensor(g.standard_normal((nx + 2, ny + 2)) * 0.3, dtype=torch.float32)
    old = u[1:-1, 1:-1] + torch.tensor(g.standard_normal((nx, ny)) * 0.01,
                                       dtype=torch.float32)
    dx, dy = 1.0 / nx, 0.7 / ny
    kw = dict(dx=dx, dy=dy, dt=1e-3, nu=0.01, volp=dx * dy)
    return u, old, face_fluxes(u, v, dx, dy), kw


@pytest.mark.parametrize("shape", [(70, 45), (29, 64)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("scheme,k", [("QUICK", 1), ("QUICK", 3), ("UPWIND", 1),
                                      ("UPWIND", 2)])
def test_pass_twin_is_bit_equal_to_the_plain_momentum_sweeps(scheme, k, shape):
    """Row 4's operands (the old field interior-shaped) on ragged grids
    (padded 72x47 and 31x66: neither side a multiple of the tile, 66 one
    past two tiles): k sweeps of the schedule equal k plain sweeps bit for
    bit, and its sum equals the staged form's."""
    nx, ny = shape
    u, old, ff, kw = _row4_problem(nx, ny, seed=k * 10 + len(scheme))
    residual = mk.momentum_residual_fn(old, ff, scheme=scheme, **kw)
    plan = mom_pass.mom_plan(nx + 2, ny + 2, k, scheme == "QUICK")
    out, ss = pass_twin(u, residual, plan)
    ref, n = mk.tiled_solve_momentum_plain(u, old, ff, scheme=scheme, **kw, tol=0.0,
                                           max_iter=k, check_every=k)
    assert n == k and torch.equal(out, ref)
    before, _ = mk.tiled_solve_momentum_plain(u, old, ff, scheme=scheme, **kw, tol=0.0,
                                              max_iter=k - 1, check_every=1)
    assert torch.equal(ss, staged_sum(before, residual, plan))


def _step_solver(nx, ny, scheme, **extra):
    from sr_for_cfd_tpu_torch.solver.cases import make_bfs_solver

    solver = make_bfs_solver(device="cpu", dtype="float32", nx=nx, ny=ny, scheme=scheme,
                             fused_step=True, pressure_solver="multigrid", **extra)
    g = np.random.default_rng(nx + ny)
    solver.warm_start({c: g.standard_normal((ny, nx)) * 0.1 for c in "uvp"})
    return solver


@pytest.mark.parametrize("scheme,k", [("UPWIND", 1), ("QUICK", 2)])
def test_pass_twin_is_bit_equal_to_the_step_momentum(scheme, k):
    """Row 3's operands (the old field padded: the step-entry field) on a
    61x38 BFS grid: the schedule equals `simple_step_plain`'s momentum
    sweeps, and its sum the staged form's."""
    from dataclasses import replace

    solver = _step_solver(61, 38, scheme, momentum_check_every=k)
    case, s = solver.case, solver.state
    nu = sk._nu_tensor(solver._nu, s.u)
    residual = sk._momentum_residual(s.u, s.ff, case, nu)
    plan = mom_pass.mom_plan(63, 40, k, scheme == "QUICK")
    out, ss = pass_twin(s.u, residual, plan)
    one = replace(case, settings=replace(case.settings, inner_tolerance=0.0,
                                         inner_max_iter=k))
    ref, n = sk._plain_momentum(s.u, s.ff, one, nu)
    assert n == k and torch.equal(out, ref)
    if k > 1:
        before = sk._plain_momentum(s.u, s.ff, replace(one, settings=replace(
            one.settings, inner_max_iter=k - 1, momentum_check_every=1)), nu)[0]
    else:
        before = s.u
    assert torch.equal(ss, staged_sum(before, residual, plan))


def _host_exits(seq, tol, max_iter, per_launch, on_best):
    """The host loop's (stale, best, exit) after each rms of `seq`."""
    t = np.float32
    rms = best = t(np.inf)
    stale = checks = it = 0
    out = []

    def go():
        return it < max_iter and (best if on_best else rms) >= t(tol) and \
            not stalled(stale, checks)

    for now in seq:
        if not go():
            break
        stale, best = stall_update(t(now), rms, best, stale)
        rms = t(now)
        checks += 1
        it += per_launch
        out.append((stale, best, it, not go()))
    return out


@pytest.mark.parametrize("on_best", [False, True])
@pytest.mark.parametrize("per_launch", [1, 3])
@pytest.mark.parametrize("case", ["tolerance", "bounce", "plateau", "nan", "max_iter"])
def test_exit_state_step_matches_the_host_policy(case, per_launch, on_best):
    g = np.random.default_rng(["tolerance", "bounce", "plateau", "nan",
                               "max_iter"].index(case))
    n = 60
    tol, max_iter = 1e-6, 1000
    if case == "tolerance":  # falls through tol
        seq = 10.0 ** -np.linspace(1, 8, n) * (1 + 0.01 * g.standard_normal(n))
    elif case == "bounce":  # through tol once, then back above it: the two
        seq = 10.0 ** -np.linspace(1, 8, n)  # tests part ways
        seq[30:] = 10.0 ** -np.linspace(5, 4, n - 30)
        tol = 2e-5
    elif case == "plateau":  # falls, then flattens: the stall ends it
        seq = np.maximum(10.0 ** -np.linspace(1, 5, n), 3e-4) * (1 + 1e-4 * g.standard_normal(n))
        tol = 0.0
    elif case == "nan":
        seq = 10.0 ** -np.linspace(1, 3, n)
        seq[17] = np.nan
    else:
        seq = 10.0 ** -np.linspace(1, 3, n)
        max_iter = 23
    seq = seq.astype(np.float32)
    ref = _host_exits(seq, tol, max_iter, per_launch, on_best)
    s = exit_loop.ExitState()
    got = []
    for now in seq:
        if s.done:
            break
        s = exit_loop.exit_state_step(s, np.float32(now), np.float32(tol), max_iter,
                                      per_launch=per_launch, on_best=on_best)
        got.append((s.stale, s.best, s.it, bool(s.done)))
    assert len(got) == len(ref) and got[-1][3]
    for (stale, best, it, done), (r_stale, r_best, r_it, r_done) in zip(got, ref):
        assert (stale, it, done) == (r_stale, r_it, r_done)
        assert (np.isnan(best) and np.isnan(r_best)) or best == r_best
    if case == "nan":
        assert len(got) == 18
    if case == "max_iter":
        assert len(got) == -(-23 // per_launch)


class _StubLib:
    """The kernel library for `MomentumLoop` on CPU tensors: the pass runs
    `pass_twin` from the source buffer into the destination, its rms and the
    state step (`exit_state_step`), or nothing once `done` is set; every
    call is recorded."""

    def __init__(self, residual):
        self.residual, self.calls = residual, []

    def __getattr__(self, name):
        if not name.startswith("srcfd_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append(name)
            if name == "srcfd_mom_pass":
                self.mom_pass(*args)
            return 0

        return call

    def mom_pass(self, addr, src, dst, old, fe, fn, fw, fs, nu, rms_out, stream):
        prm = mom_pass.Params.from_address(addr)
        assert rms_out is None and prm.state
        words = _view(prm.state, (8,), ctypes.c_int32)
        if words[5]:
            return
        plan = mom_pass.mom_plan(prm.nx2, prm.ny2, prm.k, bool(prm.quick))
        out, ss = pass_twin(_view(src, (prm.nx2, prm.ny2)).clone(), self.residual, plan)
        _view(dst, (prm.nx2, prm.ny2)).copy_(out)
        now = np.float32(np.sqrt(np.float32(ss) / np.float32(prm.n_cells)))
        w = words.numpy()
        st = exit_loop.ExitState(w[:2].view(np.float32)[0], w[:2].view(np.float32)[1],
                                 *(int(x) for x in w[2:6]))
        st = exit_loop.exit_state_step(st, now, np.float32(prm.tol), prm.max_iter,
                                       per_launch=prm.k, on_best=bool(prm.on_best))
        words.copy_(torch.from_numpy(exit_loop.state_words(st)))


class _Count:
    launches = reads = 0


def _loop(monkeypatch, residual, nx2, ny2, *, quick, k, old_padded, tol, max_iter,
          on_best, batch, ahead=False):
    stub = _StubLib(residual)
    monkeypatch.setattr(kernel_lib, "load_library", lambda: stub)
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda device: 0)
    coef = mom_pass.Coef(1.0, 1.0, 1.0, 1.0, -1.0)  # the stub takes `residual`
    loop = mom_pass.MomentumLoop(nx2, ny2, "cpu", quick=quick, k=k, old_padded=old_padded,
                                 coef=coef, tol=tol, max_iter=max_iter, on_best=on_best,
                                 batch=batch, ahead=ahead, counter=_Count())
    return loop, stub


@pytest.mark.parametrize("ahead", [False, True])
def test_row4_loop_stops_at_every_batch_position(monkeypatch, ahead):
    """QUICK, k = 3, batches of 2 passes: max_iter from 1 to 15 puts the
    exit (by max_iter) at each position of the first three batches; field
    bits and count equal the plain loop's; one host read per batch."""
    u, old, ff, kw = _row4_problem(34, 30, seed=2)
    residual = mk.momentum_residual_fn(old, ff, scheme="QUICK", **kw)
    for max_iter in range(0, 16):
        loop, stub = _loop(monkeypatch, residual, 36, 32, quick=True, k=3,
                           old_padded=False, tol=0.0, max_iter=max_iter, on_best=False,
                           batch=2, ahead=ahead)
        out, n = loop.solve(u, old, ff, torch.tensor([0.01]))
        ref, n_ref = mk.tiled_solve_momentum_plain(u, old, ff, scheme="QUICK", **kw,
                                                   tol=0.0, max_iter=max_iter,
                                                   check_every=3)
        passes = -(-max_iter // 3)
        assert n == n_ref == 3 * passes and torch.equal(out, ref), max_iter
        reads = -(-passes // 2)
        assert loop.counter.reads == reads
        launches = min(2 * (reads + int(ahead)), passes)
        assert loop.counter.launches == launches == len(stub.calls)


@pytest.mark.parametrize("tol", [3e-3, 1e-3, 3e-4])
def test_row4_loop_stops_at_the_tolerance(monkeypatch, tol):
    u, old, ff, kw = _row4_problem(34, 30, seed=4)
    residual = mk.momentum_residual_fn(old, ff, scheme="QUICK", **kw)
    loop, _ = _loop(monkeypatch, residual, 36, 32, quick=True, k=3, old_padded=False,
                    tol=tol, max_iter=300, on_best=False, batch=2)
    out, n = loop.solve(u, old, ff, torch.tensor([0.01]))
    ref, n_ref = mk.tiled_solve_momentum_plain(u, old, ff, scheme="QUICK", **kw, tol=tol,
                                               max_iter=300, check_every=3)
    assert n == n_ref < 300 and torch.equal(out, ref)
    assert loop.counter.reads == -(-(n // 3) // 2)


def test_row4_loop_stops_on_a_stall(monkeypatch):
    """tol 0: the rms reaches the float32 floor and the stall policy ends
    the loop, in both forms at the same pass."""
    u, old, ff, kw = _row4_problem(12, 10, seed=8)
    residual = mk.momentum_residual_fn(old, ff, scheme="UPWIND", **kw)
    loop, _ = _loop(monkeypatch, residual, 14, 12, quick=False, k=1, old_padded=False,
                    tol=0.0, max_iter=3000, on_best=False, batch=4)
    out, n = loop.solve(u, old, ff, torch.tensor([0.01]))
    ref, n_ref = mk.tiled_solve_momentum_plain(u, old, ff, scheme="UPWIND", **kw, tol=0.0,
                                               max_iter=3000, check_every=1)
    assert n == n_ref < 3000 and torch.equal(out, ref)


def test_loop_on_a_nan_rms_exits_after_its_pass(monkeypatch):
    """A NaN in the field: the first pass's rms is NaN and both loops stop
    after it (the rms and the best tests alike)."""
    u, old, ff, kw = _row4_problem(20, 18, seed=5)
    u = u.clone()
    u[7, 9] = float("nan")
    residual = mk.momentum_residual_fn(old, ff, scheme="QUICK", **kw)
    for on_best in (False, True):
        loop, _ = _loop(monkeypatch, residual, 22, 20, quick=True, k=1, old_padded=False,
                        tol=1e-6, max_iter=50, on_best=on_best, batch=3)
        out, n = loop.solve(u, old, ff, torch.tensor([0.01]))
        ref, n_ref = mk.tiled_solve_momentum_plain(u, old, ff, scheme="QUICK", **kw,
                                                   tol=1e-6, max_iter=50)
        assert n == n_ref == 1
        assert torch.equal(torch.isnan(out), torch.isnan(ref))


@pytest.mark.parametrize("max_iter", range(1, 14))
def test_row3_loop_stops_at_every_batch_position(monkeypatch, max_iter):
    """The fused step's loop (old field padded, the test on the best rms),
    UPWIND k = 1, batches of sk.BATCH: the exit by max_iter at each position
    of the first two batches; field bits and count equal `_plain_momentum`'s.
    At dt 0.5 the rms falls ~2x a sweep from 6.5e-2, far above the float32
    floor (where the stall policy's exits are chaotic) for all 13 sweeps."""
    from dataclasses import replace

    solver = _step_solver(30, 20, "UPWIND", inner_tolerance=1e-12, dt=0.5)
    case, s = solver.case, solver.state
    case = replace(case, settings=replace(case.settings, inner_max_iter=max_iter))
    nu = sk._nu_tensor(solver._nu, s.u)
    residual = sk._momentum_residual(s.u, s.ff, case, nu)
    loop, _ = _loop(monkeypatch, residual, 32, 22, quick=False, k=1, old_padded=True,
                    tol=1e-12, max_iter=max_iter, on_best=True, batch=sk.BATCH)
    out, n = loop.solve(s.u, s.u, s.ff, nu.reshape(1))
    ref, n_ref = sk._plain_momentum(s.u, s.ff, case, nu)
    assert n == n_ref == max_iter and torch.equal(out, ref)
    assert loop.counter.reads == -(-max_iter // sk.BATCH)


def test_row3_loop_tests_the_best_rms(monkeypatch):
    """The step's tolerance reached: the loop and `_plain_momentum` stop at
    the same sweep, which the test on the best rms decides."""
    solver = _step_solver(30, 20, "QUICK", inner_tolerance=1e-4)
    case, s = solver.case, solver.state
    nu = sk._nu_tensor(solver._nu, s.u)
    residual = sk._momentum_residual(s.u, s.ff, case, nu)
    loop, _ = _loop(monkeypatch, residual, 32, 22, quick=True, k=1, old_padded=True,
                    tol=1e-4, max_iter=case.settings.inner_max_iter, on_best=True,
                    batch=sk.BATCH)
    out, n = loop.solve(s.u, s.u, s.ff, nu.reshape(1))
    ref, n_ref = sk._plain_momentum(s.u, s.ff, case, nu)
    assert n == n_ref < case.settings.inner_max_iter and torch.equal(out, ref)


def test_row4_loop_matches_jax():
    """The stubbed device-exit loop (the schedule's twin in each pass)
    against JAX's tiled_solve_momentum in interpret mode, on JAX's own
    72x72 problem (tests/test_pallas_momentum.py), QUICK, 3 sweeps a pass:
    equal counts, fields within 2e-6 (tests/test_torch_momentum.py)."""
    import jax.numpy as jnp

    from sr_for_cfd_tpu.ops.pallas_momentum import tiled_solve_momentum as j_tiled
    from sr_for_cfd_tpu.ops.stencil import face_fluxes as j_face_fluxes

    n = 72
    dx = 1.0 / n
    g = np.random.default_rng(3)
    u = (g.standard_normal((n + 2, n + 2)) * 0.3).astype(np.float32)
    v = (g.standard_normal((n + 2, n + 2)) * 0.3).astype(np.float32)
    old = (u[1:-1, 1:-1] + (g.standard_normal((n, n)) * 0.01)
           .astype(np.float32)).astype(np.float32)
    kw = dict(dx=dx, dy=dx, dt=1e-3, nu=0.01, volp=dx * dx)
    a, ca = j_tiled(jnp.asarray(u), jnp.asarray(old),
                    j_face_fluxes(jnp.asarray(u), jnp.asarray(v), dx, dx), scheme="QUICK",
                    slab_rows=16, check_every=3, return_count=True, interpret=True,
                    tol=1e-6, max_iter=40, **kw)
    tu, told = torch.from_numpy(u), torch.from_numpy(old)
    tff = face_fluxes(tu, torch.from_numpy(v), dx, dx)
    residual = mk.momentum_residual_fn(told, tff, scheme="QUICK", **kw)
    with pytest.MonkeyPatch.context() as mp:
        loop, _ = _loop(mp, residual, n + 2, n + 2, quick=True, k=3, old_padded=False,
                        tol=1e-6, max_iter=40, on_best=False, batch=mk.BATCH)
        out, cb = loop.solve(tu, told, tff, torch.tensor([0.01]))
    assert cb == int(ca) and cb % 3 == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(a), rtol=0, atol=2e-6)


def test_row3_step_on_the_loop_matches_jax(monkeypatch):
    """The plain whole step with both momentum loops on the stubbed
    device-exit loop, against JAX's pallas_simple_step in interpret mode
    (as tests/test_torch_step.py runs it): the 12x10 BFS, UPWIND, K = 4,
    multigrid mode; equal inner counts, fields within that file's
    tolerances."""
    from sr_for_cfd_tpu.solver import cases as jcases
    from sr_for_cfd_tpu.solver import simple as jsimple
    from sr_for_cfd_tpu_torch.solver import cases as tcases
    from sr_for_cfd_tpu_torch.solver import simple as tsimple

    kw = dict(Re=400, nx=12, ny=10, dt=2e-3, scheme="UPWIND", inner_tolerance=1e-3,
              dtype="float32", fused_step=True, pressure_solver="multigrid",
              steps_per_kernel=4, chunk_size=16, mg_coarsest_sweeps=10)
    sj, st = jcases.make_bfs_solver(**kw), tcases.make_bfs_solver(device="cpu", **kw)
    rng = np.random.default_rng(11)
    fields = {c: rng.standard_normal((10, 12)) * 0.1 for c in "uvp"}
    sj.warm_start(fields)
    st.warm_start(fields)
    solves = []

    def on_the_loop(f0, ff, case, nu):
        loop, _ = _loop(monkeypatch, sk._momentum_residual(f0, ff, case, nu), 14, 12,
                        quick=False, k=1, old_padded=True, tol=case.settings.inner_tolerance,
                        max_iter=case.settings.inner_max_iter, on_best=True, batch=sk.BATCH)
        solves.append(loop)
        return loop.solve(f0, f0, ff, nu.reshape(1))

    monkeypatch.setattr(sk, "_plain_momentum", on_the_loop)
    js, jc = jsimple.simple_step(sj.state, sj.case, sj.profile, with_counts=True)
    ts, tc = tsimple.simple_step(st.state, st.case, st.profile, nu=st._nu, with_counts=True)
    assert len(solves) == 8  # two momentum loops a step, four steps
    assert tc == {key: int(val) for key, val in jc.items()}
    for c, atol in (("u", 1e-5), ("v", 1e-5), ("p", 1e-4)):
        np.testing.assert_allclose(getattr(ts, c).numpy(), np.asarray(getattr(js, c)),
                                   rtol=0, atol=atol)


def test_loop_cache_owns_what_its_blocks_point_at(monkeypatch):
    """More settings than the loop cache holds, then the first again: every
    cached loop's parameter block points at the partials, ticket and state
    of that same loop (no pointer outlives its tensor when another entry is
    evicted), sized for its shape, with the ticket at 0."""
    monkeypatch.setattr(kernel_lib, "load_library", lambda: _StubLib(None))
    mom_pass.cached_loop.cache_clear()
    coef = mom_pass.Coef(1.0, 1.0, 1.0, 1.0, -1.0)
    sites = [(20 + 2 * i, 30 + i, "cpu", bool(i % 2), 1 + i % 3, bool(i % 3), coef, 1e-6,
              100, bool(i % 2), 4, False, _Count)
             for i in range(mom_pass.cached_loop.cache_info().maxsize + 5)]
    loops = [mom_pass.cached_loop(*site) for site in sites + sites[:1]]
    info = mom_pass.cached_loop.cache_info()
    assert info.currsize == info.maxsize
    for site, loop in zip(sites + sites[:1], loops):
        nx2, ny2, _, quick, k, old_padded = site[:6]
        prm = mom_pass.Params.from_address(loop.addr)
        assert prm.partials == loop.partials.data_ptr()
        assert prm.ticket == loop.ticket.data_ptr() and prm.state == loop.state.data_ptr()
        assert (prm.nx2, prm.ny2, prm.k, prm.quick, prm.old_padded) == (
            nx2, ny2, k, int(quick), int(old_padded))
        assert loop.partials.numel() == 2 * math.ceil(nx2 / 8) * math.ceil(ny2 / 32)
        assert int(loop.ticket) == 0
    mom_pass.cached_loop.cache_clear()
