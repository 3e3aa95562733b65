"""The fused form of the tiled red-black kernel (`csrc/shard_rb.cu`), on the
CPU: its plan (`ops/shard_rb.py`), its tile schedule, and the tiled loop's
exit decided on the card (`ops/tiled_kernels.py`).

The kernel runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
Here:
- the plan at every shape the main paths give the kernel: the shared
  memory under the budget, output tiles that are whole 32 x 32 sum tiles
  anchored at inner cell (1, 1), only tile rows that hold own rows, enough
  blocks to fill the card at the large shapes; the largest kb with a plan;
  the C constants and the parameter block's layout read from the source;
- the row 9 wrapper's cache of parameter blocks: each entry owns every
  tensor whose address its block holds, however many call sites pass
  through it;
- `fused_twin`, a plain transcription of the kernel's schedule (per tile:
  the loaded region, the kb sweeps on rings that shrink by two cells a
  sweep, the own rows, the per-sum-tile partials in the threads' order,
  the last block's fixed-order sum with 0 for tiles not launched): own
  rows and sum bit-equal to `shard_rb_sweep_plain` (row 9) and to one sweep
  of `solve_pressure_plain(divide=True)` with the one-sweep form's sum
  order (row 5), and within 1e-6 of JAX's `shard_rb_sweep` in interpret
  mode (XLA:CPU contracts multiply-adds, the port does not);
- `exit_state_step`, the plain twin of the kernel's last block, against
  the host loop's `stall_update` / `stalled` over seeded rms sequences;
- the batched device-exit loop (`_TiledLoop`) driven on CPU tensors with a
  recording stub in place of the kernel library, whose fused launch runs
  the plain sweep and the twin: field bits and sweep count equal to
  `solve_pressure_plain(check_every=1, divide=True)`, with the exit at every
  position of a batch, and ceil(sweeps / BATCH) host reads.
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu_torch.ops import exit_loop, kernel_lib, shard_rb
from sr_for_cfd_tpu_torch.ops import tiled_kernels as tk
from sr_for_cfd_tpu_torch.ops.pressure_kernels import _coefficients, solve_pressure_plain
from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes
from sr_for_cfd_tpu_torch.ops.sweeps import checkerboard, stall_update, stalled
from sr_for_cfd_tpu_torch.parallel.spmd_kernels import (
    _coefficient,
    _fixed_sum,
    _tile_sum,
    shard_rb_sweep_plain,
)

torch.set_num_threads(1)

SRC = Path(shard_rb.__file__).parent.parent / "csrc" / "shard_rb.cu"

# (R, W, h, kb) of every call the main paths make: the one-rank 400^2
# sweeps block, the 8-rank 2048^2 gate band, the tiled 2050^2 grid, and
# the eight sharded levels of the one-rank 2048^2 V-cycle (kb 4, h 8)
LEVELS = [(n + 16, n + 2, 8, 4) for n in (2048, 1024, 512, 256, 128, 64, 32, 16)]
MAIN_SHAPES = [(432, 402, 16, 8), (288, 2050, 16, 8), (2050, 2050, 1, 1), *LEVELS]
# shapes with at least one block per SM
LARGE = {(432, 402, 16, 8), (288, 2050, 16, 8), (2050, 2050, 1, 1), LEVELS[0],
         LEVELS[1], LEVELS[2]}


def test_constants_and_parameter_block_are_the_kernel_source():
    src = SRC.read_text()
    budget = re.search(r"#define SHARD_RB_SMEM_BUDGET \((\d+) \* 1024\)", src)
    assert int(budget.group(1)) * 1024 == shard_rb.SMEM_BUDGET
    assert int(re.search(r"#define SUM_TILE (\d+)", src).group(1)) == shard_rb.SUM_TILE
    # the static sums (4 per thread at most) fit beside the budget in the
    # 227 KB a block can have
    assert shard_rb.SMEM_BUDGET + 4 * 4 * shard_rb.THREADS + 4 <= 232448
    body = re.search(r"struct ShardRbParams \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        words = decl.replace(",", " ").split()
        if not words:
            continue
        kind = {"float*": ctypes.c_void_p, "unsigned*": ctypes.c_void_p,
                "TiledState*": ctypes.c_void_p, "int": ctypes.c_int,
                "float": ctypes.c_float}[words[0]]
        fields += [(name, kind) for name in words[1:]]
    assert fields == shard_rb.Params._fields_
    assert ctypes.sizeof(shard_rb.Params) == 144


@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_of_the_main_path_shapes(shape):
    R, W, h, kb = shape
    plan = shard_rb.shard_rb_plan(R, W, h, kb)
    rows = R - 2 * h
    assert plan.ot % shard_rb.SUM_TILE == 0 and plan.ot in (32, 64)
    assert plan.smem == shard_rb.smem_bytes(plan.ot, kb) <= shard_rb.SMEM_BUDGET
    # tile rows from the first to the last that holds an own row
    # (block rows [h, rows + h), inner index k - 1), all tile columns
    first, last = (h - 1) // plan.ot, (rows + h - 2) // plan.ot
    assert (plan.a0, plan.tiles_y) == (first, last - first + 1)
    assert plan.tiles_x * plan.ot >= W - 2 > (plan.tiles_x - 1) * plan.ot
    # the sum tiles: the one-sweep form's grid over the inner cells
    assert (plan.gx_sum, plan.gy_sum) == (math.ceil((W - 2) / 32), math.ceil((R - 2) / 32))
    assert plan.n_sum == shard_rb.n_partials(R, W)
    m = plan.ot // 32
    assert plan.z0 == plan.a0 * m * plan.gx_sum
    assert plan.z1 == min((plan.a0 + plan.tiles_y) * m, plan.gy_sum) * plan.gx_sum
    if shape in LARGE:
        assert plan.n_tiles >= shard_rb.MIN_BLOCKS
    # 64-cell tiles wherever they still fill the card
    tiles64 = ((rows + h - 2) // 64 - (h - 1) // 64 + 1) * math.ceil((W - 2) / 64)
    assert plan.ot == (64 if tiles64 >= shard_rb.MIN_BLOCKS else 32)
    if shape == (432, 402, 16, 8):
        assert plan.ot == 32 and plan.smem == 4 * (2 * 64 * 64 + 32 * 32)


def test_plan_refusals_and_the_largest_kb():
    """kb 33 is the largest with a plan; `fits` says so, and the row 9
    wrapper sends a larger kb to the one-sweep form (card tests)."""
    with pytest.raises(ValueError, match="budget"):
        shard_rb.shard_rb_plan(432, 402, 68, 34)
    assert shard_rb.shard_rb_plan(432, 402, 66, 33).smem <= shard_rb.SMEM_BUDGET
    assert [kb for kb in range(1, 100) if shard_rb.fits(kb)] == list(range(1, 34))
    with pytest.raises(ValueError):
        shard_rb.shard_rb_plan(40, 20, 1, 1, ot=48)
    with pytest.raises(ValueError):
        shard_rb.shard_rb_plan(4, 20, 2, 1)
    # past the budget at 64 cells, the plan takes 32
    assert shard_rb.shard_rb_plan(4160, 4098, 50, 24).ot == 64
    assert shard_rb.shard_rb_plan(4160, 4098, 50, 25).ot == 32


def test_row9_parameter_cache_owns_what_its_blocks_point_at():
    """More call sites than the cache holds, then the first again: every
    entry's parameter block points at the partials and ticket of that same
    entry (no pointer outlives its tensor when another entry is evicted),
    sized for its block, with the ticket at 0."""
    from sr_for_cfd_tpu_torch.parallel import spmd_kernels as sk

    sk._fused_params.cache_clear()
    cpu = torch.device("cpu")
    sites = [(40 + 2 * i, 20 + i, 2, 1, 36 + 2 * i, 1.0, 1.0, 1.0, -0.25, cpu)
             for i in range(sk._fused_params.cache_info().maxsize + 6)]
    entries = [sk._fused_params(*site) for site in sites + sites[:1]]
    assert sk._fused_params.cache_info().currsize == sk._fused_params.cache_info().maxsize
    for site, (addr, (params, partials, ticket)) in zip(sites + sites[:1], entries):
        R, W = site[:2]
        assert addr == ctypes.addressof(params)
        prm = shard_rb.Params.from_address(addr)
        assert prm.partials == partials.data_ptr() and prm.ticket == ticket.data_ptr()
        assert (prm.R, prm.W) == (R, W) and partials.numel() == shard_rb.n_partials(R, W)
        assert int(ticket) == 0
    sk._fused_params.cache_clear()


def fused_twin(ext, b_ext, row0, *, nxg, h, kb, plan, inv_dx2, inv_dy2, volp, step):
    """The fused kernel's schedule in plain PyTorch: (own rows, sum).
    `step(r)` is the update of one cell."""
    R, W = ext.shape
    rows = R - 2 * h
    ot, e = plan.ot, 2 * kb
    L = ot + 4 * kb
    ioff = row0 - (h - 1)
    klo, khi = max(1, 1 - ioff), min(R - 2, nxg - ioff)
    out = torch.full((rows, W), float("nan"))
    partials = torch.full((plan.n_sum,), float("nan"))
    li = torch.arange(L)[:, None]
    lj = torch.arange(L)[None, :]
    for q in range(plan.n_tiles):
        ta, tb = plan.a0 + q // plan.tiles_x, q % plan.tiles_x
        k0, j0 = 1 + ta * ot - e, 1 + tb * ot - e
        kk, jj = k0 + li, j0 + lj
        inside = (kk >= 0) & (kk < R) & (jj >= 0) & (jj < W)
        kc, jc = kk.clamp(0, R - 1).expand(L, L), jj.clamp(0, W - 1).expand(L, L)
        sf = torch.where(inside, ext[kc, jc], 0.0)
        ring = (li >= 1) & (li < L - 1) & (lj >= 1) & (lj < L - 1)
        sb = torch.where(inside & ring, b_ext[kc, jc], 0.0)
        upd = (kk >= klo) & (kk <= khi) & (jj >= 1) & (jj <= W - 2)
        red = (kk + jj + ioff) % 2 == 0
        own = (kk >= h) & (kk < rows + h)
        tile = (li >= e) & (li < e + ot) & (lj >= e) & (lj < e + ot)
        terms = torch.zeros((L, L))
        for s in range(kb):
            for half in (0, 1):
                d = 2 * (kb - 1 - s) + 1 - half
                region = (li >= e - d) & (li < e + ot + d) & (lj >= e - d) & (lj < e + ot + d)
                mask = upd & region & (red if half == 0 else ~red)
                c = sf[1:-1, 1:-1]
                lap = volp * ((sf[2:, 1:-1] - 2.0 * c + sf[:-2, 1:-1]) * inv_dx2
                              + (sf[1:-1, 2:] - 2.0 * c + sf[1:-1, :-2]) * inv_dy2)
                r = torch.zeros((L, L))
                r[1:-1, 1:-1] = sb[1:-1, 1:-1] - lap
                sf = torch.where(mask, sf + step(r), sf)
                if s == kb - 1:
                    terms = torch.where(mask & own & tile, r * r, terms)
        keep = own & tile & (jj <= W - 2)
        for a in range(ot):
            k = k0 + e + a
            if h <= k < rows + h:
                row = out[k - h]
                sel = keep[e + a]
                row[jj[0][sel]] = sf[e + a][sel]
                if tb == 0:
                    row[0] = ext[k, 0]
                if tb == plan.tiles_x - 1:
                    row[W - 1] = ext[k, W - 1]
        t = terms[e:e + ot, e:e + ot]
        m = ot // 32
        for sy in range(m):
            for sx in range(m):
                SY, SX = ta * m + sy, tb * m + sx
                if SY < plan.gy_sum and SX < plan.gx_sum:
                    cells = t[32 * sy:32 * sy + 32, 32 * sx:32 * sx + 32].reshape(1, -1)
                    partials[SY * plan.gx_sum + SX] = _fixed_sum(cells)[0]
    zeros = torch.zeros_like(partials)
    zeros[plan.z0:plan.z1] = partials[plan.z0:plan.z1]
    return out, _fixed_sum(zeros[None])[0]


# the row 9 coefficients of tests/test_torch_spmd_kernel.py
NXG, NY = 130, 37
INV_DX2, INV_DY2 = float(NXG * NXG) / 100.0, float(NY * NY) / 9.0
VOLP = (10.0 / NXG) * (3.0 / NY)
COEF = dict(nxg=NXG, inv_dx2=INV_DX2, inv_dy2=INV_DY2, volp=VOLP, sor=1.8)


def _band(rank_rows, row0, h, seed):
    """A seeded (rows + 2h, NY + 2) block of a NXG-row grid, as
    spmd_step.assemble cuts it (the ghost row repeated beyond the domain)
    and its right-hand side (zero beyond the domain and on the y-ghosts)."""
    g = np.random.default_rng(seed)
    p = g.standard_normal((NXG + 2, NY + 2)).astype(np.float32)
    b = (g.standard_normal((NXG, NY)) * 50.0).astype(np.float32)
    gi = np.arange(row0 - h, row0 + rank_rows + h)
    ext = p[np.clip(gi + 1, 0, NXG + 1)]
    b_ext = np.zeros_like(ext)
    inside = (gi >= 0) & (gi < NXG)
    b_ext[inside, 1:-1] = b[gi[inside]]
    return torch.as_tensor(ext), torch.as_tensor(b_ext)


@pytest.mark.parametrize("ot", [32, 64])
@pytest.mark.parametrize("kb,rows,row0", [(1, 40, 0), (2, 40, 40), (3, 50, 80),
                                           (4, 70, 60), (8, 44, 20)])
def test_fused_schedule_is_bit_equal_to_the_plain_row9_sweep(kb, rows, row0, ot):
    h = 2 * kb
    ext, b_ext = _band(rows, row0, h, seed=kb * 100 + rows)
    plan = shard_rb.shard_rb_plan(rows + 2 * h, NY + 2, h, kb, ot=ot)
    inv_ap = _coefficient(INV_DX2, INV_DY2, VOLP, 1.8)
    own, ss = fused_twin(ext, b_ext, row0, nxg=NXG, h=h, kb=kb, plan=plan,
                         inv_dx2=INV_DX2, inv_dy2=INV_DY2, volp=VOLP,
                         step=lambda r: r * inv_ap)
    ref, ss_ref = shard_rb_sweep_plain(ext, b_ext, row0, h=h, kb=kb, **COEF)
    assert torch.equal(own, ref)
    assert torch.equal(ss, ss_ref)


def test_fused_schedule_matches_jax():
    """The schedule's own rows and sum against JAX's kernel in interpret
    mode, on an interior rank's band at kb 3."""
    import jax.numpy as jnp

    from sr_for_cfd_tpu.parallel.spmd_pallas import shard_rb_sweep as jax_sweep

    kb, h, rows, row0 = 3, 6, 40, 45
    ext, b_ext = _band(rows, row0, h, seed=7)
    plan = shard_rb.shard_rb_plan(rows + 2 * h, NY + 2, h, kb)
    inv_ap = _coefficient(INV_DX2, INV_DY2, VOLP, 1.8)
    own, ss = fused_twin(ext, b_ext, row0, nxg=NXG, h=h, kb=kb, plan=plan,
                         inv_dx2=INV_DX2, inv_dy2=INV_DY2, volp=VOLP,
                         step=lambda r: r * inv_ap)
    j_own, j_ss = jax_sweep(jnp.asarray(ext.numpy()), jnp.asarray(b_ext.numpy()),
                            jnp.full((1, 1), row0, jnp.int32), h=h, kb=kb,
                            interpret=True, **COEF)
    j_own = np.asarray(j_own)
    assert np.max(np.abs(own.numpy() - j_own)) <= 1e-6 * np.max(np.abs(j_own))
    assert abs(float(ss) - float(j_ss)) <= 1e-6 * abs(float(j_ss))


@pytest.mark.parametrize("ot", [32, 64])
def test_fused_schedule_is_one_tiled_sweep(ot):
    """Row 5: the whole padded 70x45 grid as a one-rank block with a
    one-row halo, kb 1, the divide update: the field equals one sweep of
    solve_pressure_plain(divide=True); the sum is the one-sweep form's
    (32 x 32 tiles of the inner cells, `_tile_sum`) and gives the plain
    loop's rms to a float32 rounding."""
    g = np.random.default_rng(5)
    nx, ny = 70, 45
    lx, ly = 1.0, 0.7
    dx, dy = lx / nx, ly / ny
    u, v = (torch.tensor(g.standard_normal((nx + 2, ny + 2)) * 0.1, dtype=torch.float32)
            for _ in range(2))
    p = torch.tensor(g.standard_normal((nx + 2, ny + 2)) * 0.01, dtype=torch.float32)
    ff = face_fluxes(u, v, dx, dy)
    geo = dict(dx=dx, dy=dy, dt=1e-3, rho=1.0, volp=dx * dy)
    inv_dx2, inv_dy2, sor, _, ap_d = _coefficients(dx, dy, dx * dy, 1.9, nx, ny)
    b = torch.zeros_like(p)
    b[1:-1, 1:-1] = (1.0 / 1e-3) * ff.divergence_sum()
    plan = shard_rb.shard_rb_plan(nx + 2, ny + 2, 1, 1, ot=ot)
    ap_t = torch.tensor(ap_d)
    own, ss = fused_twin(p, b, 0, nxg=nx, h=1, kb=1, plan=plan, inv_dx2=inv_dx2,
                         inv_dy2=inv_dy2, volp=dx * dy, step=lambda r: sor * r / ap_t)
    ref, n = solve_pressure_plain(p, ff, **geo, tol=0.0, max_iter=1, check_every=1,
                                  sor=1.9, divide=True)
    assert n == 1 and torch.equal(own, ref[1:-1])
    # the one-sweep form's sum: r1^2 on red, r2^2 on black inner cells
    red = checkerboard(nx, ny)
    c = p[1:-1, 1:-1]
    lap = lambda f, c: (dx * dy) * ((f[2:, 1:-1] - 2.0 * c + f[:-2, 1:-1]) * inv_dx2  # noqa: E731
                                    + (f[1:-1, 2:] - 2.0 * c + f[1:-1, :-2]) * inv_dy2)
    r1 = b[1:-1, 1:-1] - lap(p, c)
    half = p.clone()
    half[1:-1, 1:-1] = c + torch.where(red, sor * r1 / ap_t, 0.0)
    r2 = b[1:-1, 1:-1] - lap(half, half[1:-1, 1:-1])
    terms = torch.zeros_like(p)
    terms[1:-1, 1:-1] = torch.where(red, r1 * r1, r2 * r2)
    assert torch.equal(ss, _tile_sum(terms))
    rms = np.float32(np.sqrt(np.float32(ss) / np.float32(nx * ny)))
    rms_plain = np.float32(torch.sqrt(torch.sum(terms) / (nx * ny)))
    assert abs(rms - rms_plain) <= 1e-6 * rms_plain


def _host_exits(seq, tol, max_iter):
    """The host loop's (stale, best, exit) after each rms of `seq`."""
    t = np.float32
    rms = best = t(np.inf)
    stale = checks = it = 0
    out = []
    for now in seq:
        if not (it < max_iter and rms >= t(tol) and not stalled(stale, checks)):
            break
        stale, best = stall_update(t(now), rms, best, stale)
        rms = t(now)
        checks += 1
        it += 1
        go = it < max_iter and rms >= t(tol) and not stalled(stale, checks)
        out.append((stale, best, not go))
    return out


@pytest.mark.parametrize("case", ["tolerance", "plateau", "nan", "max_iter", "noisy"])
def test_exit_state_twin_matches_the_host_policy(case):
    g = np.random.default_rng(["tolerance", "plateau", "nan", "max_iter", "noisy"].index(case))
    n = 60
    tol, max_iter = 1e-6, 1000
    if case == "tolerance":  # falls through tol
        seq = 10.0 ** -np.linspace(1, 8, n) * (1 + 0.01 * g.standard_normal(n))
    elif case == "plateau":  # falls, then flattens at a floor: the stall ends it
        seq = np.maximum(10.0 ** -np.linspace(1, 5, n), 3e-4) * (1 + 1e-4 * g.standard_normal(n))
        tol = 0.0
    elif case == "nan":
        seq = 10.0 ** -np.linspace(1, 3, n)
        seq[17] = np.nan
    elif case == "max_iter":
        seq = 10.0 ** -np.linspace(1, 3, n)
        max_iter = 23
    else:  # rises and falls: stale counts up and resets
        seq = np.abs(1.0 + 0.3 * g.standard_normal(n)) * 10.0 ** -np.linspace(1, 4, n)
        tol, max_iter = 0.0, n
    seq = seq.astype(np.float32)
    ref = _host_exits(seq, tol, max_iter)
    s = exit_loop.ExitState()
    got = []
    for now in seq:
        if s.done:
            break
        s = exit_loop.exit_state_step(s, np.float32(now), np.float32(tol), max_iter)
        got.append((s.stale, s.best, bool(s.done)))
    assert len(got) == len(ref) and got[-1][2]
    for (stale, best, done), (r_stale, r_best, r_done) in zip(got, ref):
        assert stale == r_stale and done == r_done
        assert (np.isnan(best) and np.isnan(r_best)) or best == r_best
    if case == "nan":
        assert len(got) == 18
    if case == "max_iter":
        assert len(got) == 23
    if case == "plateau":
        assert len(got) < n and got[-1][0] >= 2


class _StubLib:
    """The kernel library for `_TiledLoop` on CPU tensors: the fused launch
    runs one plain sweep (solve_pressure_plain's arithmetic, divide form)
    from the source buffer into the other and the kernel's state update
    (`exit_state_step`), or nothing once `done` is set; every call is
    recorded."""

    def __init__(self):
        self.calls = []
        self.loop = None

    def __getattr__(self, name):
        if not name.startswith("srcfd_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            if name == "srcfd_shard_rb_fused":
                self.sweep(*args)
            return 0

        return call

    def sweep(self, addr, f_in, out, b, ss_out, row0, stream):
        loop = self.loop
        prm = shard_rb.Params.from_address(addr)
        assert prm.state == loop.state.data_ptr() and row0 == 0 and prm.mode == 1
        assert ss_out is None
        src = next(x for x in loop.bufs if x.data_ptr() == f_in)
        dst = next(x for x in loop.bufs if x is not src)
        assert out == dst.data_ptr() + 4 * loop.ny2 and b == loop.b.data_ptr()
        words = loop.state.numpy()
        if words[5]:
            return
        nx, ny = loop.nx2 - 2, loop.ny2 - 2
        red = checkerboard(nx, ny)
        rhs = loop.b[1:-1, 1:-1]
        ap_t = torch.tensor(prm.ap_d)

        def half(f, mask):
            c = f[1:-1, 1:-1]
            fd = prm.volp * ((f[2:, 1:-1] - 2.0 * c + f[:-2, 1:-1]) * prm.inv_dx2
                             + (f[1:-1, 2:] - 2.0 * c + f[1:-1, :-2]) * prm.inv_dy2)
            r = rhs - fd
            f = f.clone()
            f[1:-1, 1:-1] = c + torch.where(mask, prm.sor * r / ap_t, 0.0)
            return f, r

        f, r1 = half(src, red)
        f, r2 = half(f, ~red)
        dst[1:-1] = f[1:-1]
        ss = torch.sum(torch.where(red, r1 * r1, 0.0) + torch.where(red, 0.0, r2 * r2))
        now = np.float32(torch.sqrt(ss / (nx * ny)).item())
        s = exit_loop.ExitState(words[:2].view(np.float32)[0], words[:2].view(np.float32)[1],
                         *(int(w) for w in words[2:6]))
        s = exit_loop.exit_state_step(s, now, np.float32(prm.tol), prm.max_iter)
        loop.state.copy_(torch.from_numpy(exit_loop.state_words(s)))


def _tiled_problem(n, seed):
    g = np.random.default_rng(seed)
    dx = dy = 1.0 / n
    u, v = (torch.tensor(g.standard_normal((n + 2, n + 2)) * 0.1, dtype=torch.float32)
            for _ in range(2))
    p = torch.tensor(g.standard_normal((n + 2, n + 2)) * 0.01, dtype=torch.float32)
    return p, face_fluxes(u, v, dx, dy), dict(dx=dx, dy=dy, dt=1e-3, rho=1.0, volp=dx * dy)


def _run_loop(monkeypatch, p, ff, geo, tol, max_iter, sor=1.9):
    stub = _StubLib()
    monkeypatch.setattr(kernel_lib, "load_library", lambda: stub)
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda device: 0)
    nx2, ny2 = p.shape
    inv_dx2, inv_dy2, sor, _, ap_d = _coefficients(geo["dx"], geo["dy"], geo["volp"], sor,
                                                   nx2 - 2, ny2 - 2)
    loop = tk._TiledLoop(nx2, ny2, "cpu", inv_dx2, inv_dy2, geo["volp"], sor, ap_d, tol,
                         max_iter)
    stub.loop = loop
    launches, reads = tk.tiled_solve_pressure.launches, tk.tiled_solve_pressure.reads
    out, n = loop.solve(p, (geo["rho"] / geo["dt"]) * ff.divergence_sum())
    return (out, n, tk.tiled_solve_pressure.launches - launches,
            tk.tiled_solve_pressure.reads - reads, stub)


def test_device_exit_loop_stops_at_every_batch_position(monkeypatch):
    """max_iter from 1 to 2 BATCH + 1 puts the exit (by max_iter) at every
    position of the first, second and third batch; field bits and count
    equal the plain loop's, launches = max_iter rounded up to a batch
    within the launches enqueued, one host read per batch."""
    p, ff, geo = _tiled_problem(20, 11)
    for max_iter in range(0, 2 * tk.BATCH + 2):
        out, n, launches, reads, stub = _run_loop(monkeypatch, p, ff, geo, 0.0, max_iter)
        ref, n_ref = solve_pressure_plain(p, ff, **geo, tol=0.0, max_iter=max_iter,
                                          check_every=1, sor=1.9, divide=True)
        assert n == n_ref == max_iter and torch.equal(out, ref), max_iter
        assert reads == math.ceil(max_iter / tk.BATCH)
        assert launches == max_iter == len(stub.calls)


@pytest.mark.parametrize("tol", [1e-2, 3e-3, 1e-3])
def test_device_exit_loop_stops_at_the_tolerance(monkeypatch, tol):
    p, ff, geo = _tiled_problem(24, 3)
    out, n, launches, reads, _ = _run_loop(monkeypatch, p, ff, geo, tol, 500)
    ref, n_ref = solve_pressure_plain(p, ff, **geo, tol=tol, max_iter=500, check_every=1,
                                      sor=1.9, divide=True)
    assert n == n_ref < 500 and torch.equal(out, ref)
    # the batch after the exit's was enqueued before the read (no-ops)
    assert reads == math.ceil(n / tk.BATCH)
    assert launches == min((reads + 1) * tk.BATCH, 500)
    assert torch.equal(out[0], p[0]) and torch.equal(out[:, -1], p[:, -1])


def test_device_exit_loop_stops_on_a_stall(monkeypatch):
    """tol 0 on a small grid: the rms reaches the float32 floor and the
    stall policy ends the loop, in both forms at the same sweep."""
    p, ff, geo = _tiled_problem(10, 8)
    out, n, _, reads, _ = _run_loop(monkeypatch, p, ff, geo, 0.0, 5000)
    ref, n_ref = solve_pressure_plain(p, ff, **geo, tol=0.0, max_iter=5000, check_every=1,
                                      sor=1.9, divide=True)
    assert n == n_ref < 5000 and torch.equal(out, ref)
    assert reads == math.ceil(n / tk.BATCH)
