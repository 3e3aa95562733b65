"""The one-warp SOR loop of row 1 (`csrc/rb_sor.cu`, `rb_sor_warp_kernel`)
and its wrapper's routing (`ops/pressure_kernels.py`), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
Here:
- (a) a numpy float32 transcription of the kernel's rms schedule (slots
  l + 32m a lane, red then black cells of each slot in increasing k, the
  tree's steps 128..32 inside the lane and 16..1 as shuffles) bit for bit
  against a transcription of the single-block loop's 256-thread strided sum
  and shared-memory tree, at the shapes the warp route takes; a schedule
  one slot off differs;
- (b) the kernel's right-hand side, ((e + n) + w) + s times float32(rho /
  dt), bit for bit against the plain path's `rhs`;
- (c) the route table at its three boundaries, with the limits read from
  the C source;
- (d) the card path driven on CPU tensors with a recording stub in place
  of the kernel library, whose warp launch runs `warp_twin` (the kernel's
  arithmetic in numpy float32): one launch a call, the flux pointers,
  shape and mode passed, no right-hand side built and no copy of p made
  on the host, the field and count of the twin returned; the twin's field
  bit-equal to `solve_pressure_plain` and its count equal.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu_torch.ops import kernel_lib
from sr_for_cfd_tpu_torch.ops import pressure_kernels as pk
from sr_for_cfd_tpu_torch.ops.stencil import FaceFluxes, face_fluxes
from sr_for_cfd_tpu_torch.ops.sweeps import (
    STALL_MIN_CHECKS,
    STALL_PATIENCE,
    STALL_RATIO,
    STALL_RESET_RATIO,
    stall_update,
    stalled,
)

torch.set_num_threads(1)

F32 = np.float32
SOURCE = Path(pk.__file__).resolve().parent.parent / "csrc" / "rb_sor.cu"
WARP_SHAPES = [(10, 10), (20, 20), (30, 30), (1, 30), (30, 1)]


def _colour(nx, ny):
    """(i + j) & 1 of the interior cells in k = (i-1)*ny + (j-1) order."""
    i, j = np.meshgrid(np.arange(1, nx + 1), np.arange(1, ny + 1), indexing="ij")
    return ((i + j) & 1).ravel()


def block_sum(r2, nx, ny):
    """The single-block loop's sum: thread t adds the red, then the black
    cells of k = t, t + 256, ... of its colour; srcfd_block_sum's tree."""
    r2, colour = r2.ravel(), _colour(nx, ny)
    sh = np.zeros(256, F32)
    for t in range(256):
        acc = F32(0.0)
        for c in (0, 1):
            for k in range(t, nx * ny, 256):
                if colour[k] == c:
                    acc = F32(acc + r2[k])
        sh[t] = acc
    s = 128
    while s > 0:
        sh[:s] = sh[:s] + sh[s:2 * s]
        s //= 2
    return sh[0]


def warp_slots(nx, ny):
    """The cells the one-warp kernel sums into each of its 256 slots, in
    its order: lane l holds slots l + 32m (m < 8), each the red, then the
    black cells of k = slot + 256q (q < 4), by the colour bits the lane
    made."""
    n = nx * ny
    slots = [[] for _ in range(256)]
    for l in range(32):
        black = 0
        for m in range(8):
            for q in range(4):
                k = l + 32 * m + 256 * q
                if k < n and (k // ny + k % ny) & 1:
                    black |= 1 << (4 * m + q)
        for m in range(8):
            for c in (0, 1):
                for q in range(4):
                    k = l + 32 * m + 256 * q
                    if k < n and ((black >> (4 * m + q)) & 1) == c:
                        slots[l + 32 * m].append(k)
    return slots


def warp_sum(r2, slots):
    """The one-warp kernel's sum of r2 over `slots`: each slot from 0 in
    its order, steps 128, 64, 32 of the tree as adds in the lane, 16..1 by
    __shfl_down_sync (a lane past 31 reads its own value)."""
    r2 = r2.ravel()
    v = np.zeros((32, 8), F32)
    for l in range(32):
        for m in range(8):
            acc = F32(0.0)
            for k in slots[l + 32 * m]:
                acc = F32(acc + r2[k])
            v[l, m] = acc
    v[:, :4] = v[:, :4] + v[:, 4:]
    v[:, :2] = v[:, :2] + v[:, 2:4]
    s = v[:, 0] + v[:, 1]
    for d in (16, 8, 4, 2, 1):
        src = np.where(np.arange(32) + d < 32, np.roll(s, -d), s)
        s = s + src
    return s[0]


def _one_slot_off(slots, k, ny):
    """`slots` with cell k summed one slot later."""
    out = [list(c) for c in slots]
    t = k % 256
    out[t].remove(k)
    colour = lambda c: ((c // ny + c % ny) & 1, c)  # noqa: E731
    out[(t + 1) % 256] = sorted(out[(t + 1) % 256] + [k], key=colour)
    return out


def _r2(rng, nx, ny):
    """r^2 of residuals within a decade of each other, as a check sees them."""
    return (rng.standard_normal((nx, ny)) * 10.0 ** rng.uniform(-1, 0, (nx, ny))
            ).astype(F32) ** 2


@pytest.mark.parametrize("nx,ny", WARP_SHAPES)
def test_warp_rms_schedule_keeps_the_block_sum(nx, ny):
    rng = np.random.default_rng(nx * 100 + ny)
    slots = warp_slots(nx, ny)
    n = nx * ny
    wrong = [_one_slot_off(slots, k, ny) for k in range(0, n, max(1, n // 16))]
    off = []
    for _ in range(4):
        r2 = _r2(rng, nx, ny)
        ref = block_sum(r2, nx, ny).view(np.int32)
        assert warp_sum(r2, slots).view(np.int32) == ref
        off += [warp_sum(r2, w).view(np.int32) != ref for w in wrong]
    # schedules one slot off change the bits (some of them, on some inputs)
    assert any(off)


@pytest.mark.parametrize("rho,dt", [(1.0, 2e-3), (1.0, 1e-3), (1.2, 7e-4)])
def test_kernel_rhs_order_is_the_plain_path_s(rho, dt):
    rng = np.random.default_rng(7)
    u, v = (torch.tensor(rng.standard_normal((22, 14)) * 0.3, dtype=torch.float32)
            for _ in range(2))
    ff = face_fluxes(u, v, 0.5, 0.2)
    e, n, w, s = (t.numpy() for t in ff)
    b = (((e + n) + w) + s) * F32(rho / dt)
    assert np.array_equal(b.view(np.int32), pk.rhs(ff, rho, dt).numpy().view(np.int32))


def _c_constants():
    src = SOURCE.read_text()
    warp_max = int(re.search(r"#define RB_WARP_MAX (\d+)", src).group(1))
    small = re.search(r"int srcfd_rb_small_max_cells\(void\) \{.*?return (.*?);", src,
                      re.S).group(1)
    small = eval(small.replace("(int)sizeof(float)", "4"))
    return warp_max, small


def test_route_by_size_at_its_boundaries():
    warp_max, small = _c_constants()
    assert warp_max == pk.WARP_MAX == 32 and small == 5888
    cases = {(3, 3): "warp", (12, 12): "warp", (22, 22): "warp",
             (32, 32): "warp", (32, 3): "warp", (3, 32): "warp",
             (33, 32): "block", (32, 33): "block", (33, 3): "block",
             (64, 92): "block", (32, 184): "block",  # 5888 cells
             (64, 93): "two_launch", (77, 77): "two_launch",
             (402, 402): "two_launch"}
    for (nx2, ny2), want in cases.items():
        assert pk.route(nx2, ny2, small) == want, (nx2, ny2)


def _shfl_down(x):
    """__shfl_down_sync(x, 1): lane l gets lane l + 1's value, lane 31 its own."""
    return np.concatenate([x[1:], x[-1:]])


def _shfl_up(x):
    """__shfl_up_sync(x, 1): lane l gets lane l - 1's value, lane 0 its own."""
    return np.concatenate([x[:1], x[:-1]])


def warp_twin(p, e, n, w, s, nx2, ny2, coef, rhodt, tol, max_iter, check_every):
    """The one-warp kernel transcribed lane by lane in numpy float32 (an
    axis of 32 lanes, a lane per padded column, ROWS rows a lane): b from
    the fluxes in its order; each half-sweep in row pairs (i, i + 1), i
    odd, up to ROWS, where a lane's cell of the colour is the lower row on
    one parity of j and the upper on the other, its j +- 1 neighbours the
    other row of the neighbouring lanes by shuffles, every pair's residual
    before the updates, rows past nx masked; the last sweep of a check
    writes r^2 at k = (row-1)*ny + (j-1); the sum by `warp_sum`; the stall
    policy. Returns (field, sweeps, rms)."""
    inv_dx2, inv_dy2, volp, sor, inv_ap, ap_d = map(F32, coef[:6])
    mode = coef[6]
    nx, ny = nx2 - 2, ny2 - 2
    rows = 12 if nx2 <= 12 else 22 if nx2 <= 22 else 32
    lanes = np.arange(32)
    col = (lanes >= 1) & (lanes <= ny)
    f = np.zeros((rows, 32), F32)
    f[:nx2, :ny2] = p
    b = np.zeros((rows, 32), F32)
    b[1:nx + 1, 1:ny + 1] = (((e + n) + w) + s) * F32(rhodt)
    slots = warp_slots(nx, ny)
    r2s = np.zeros(nx * ny, F32)
    two = F32(2.0)
    rms = best = F32(np.inf)
    stale = checks = it = 0
    while it < max_iter and rms >= F32(tol) and not stalled(stale, checks):
        for sweep in range(check_every):
            for c in (0, 1):
                lo = ((lanes + 1) & 1) == c
                pairs = []
                for i in range(1, rows - 2, 2):
                    other = np.where(lo, f[i + 1], f[i])
                    f_n, f_s = _shfl_down(other), _shfl_up(other)
                    fc = np.where(lo, f[i], f[i + 1])
                    f_e = np.where(lo, f[i + 1], f[i + 2])
                    f_w = np.where(lo, f[i - 1], f[i])
                    fd = volp * ((f_e - two * fc + f_w) * inv_dx2
                                 + (f_n - two * fc + f_s) * inv_dy2)
                    pairs.append((i, fc, np.where(lo, b[i], b[i + 1]) - fd))
                for i, fc, r in pairs:
                    row = np.where(lo, i, i + 1)
                    mine = col & (row <= nx)
                    step = (sor * r) / ap_d if mode == 1 else sor * r * inv_ap
                    nv = fc + step
                    f[i] = np.where(mine & lo, nv, f[i])
                    f[i + 1] = np.where(mine & ~lo, nv, f[i + 1])
                    if sweep == check_every - 1:
                        r2s[((row - 1) * ny + lanes - 1)[mine]] = (r * r)[mine]
        now = np.sqrt(warp_sum(r2s, slots) / F32(nx * ny)).astype(F32)
        stale, best = stall_update(now, rms, best, stale)
        rms = now
        checks += 1
        it += check_every
    return f[:nx2, :ny2], it, rms


def _coef(geo, nx, ny, divide):
    dx2, dy2, sor, inv_ap, ap_d = pk._coefficients(geo["dx"], geo["dy"], geo["volp"], 1.0,
                                                   nx, ny)
    return (dx2, dy2, geo["volp"], sor, inv_ap, ap_d, int(divide))


@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("nx,ny,sweeps", [(10, 10, 64), (7, 9, 24), (20, 20, 16),
                                          (30, 30, 8), (1, 30, 16), (30, 1, 16),
                                          (13, 30, 8)])
def test_warp_twin_is_the_plain_version(nx, ny, sweeps, divide):
    """The kernel's schedule (row pairs, shuffles, residuals before the
    updates) gives the plain version's field bit for bit: the in-place
    half-sweep semantics."""
    p, ff, geo = _problem(nx * 31 + ny, nx, ny)
    f, it, _ = warp_twin(p.numpy(), *(t.numpy() for t in ff), nx + 2, ny + 2,
                         _coef(geo, nx, ny, divide), geo["rho"] / geo["dt"], 0.0,
                         sweeps, 8)
    ref, n_ref = pk.solve_pressure_plain(p, ff, **geo, tol=0.0, max_iter=sweeps,
                                         divide=divide)
    assert it == n_ref and np.array_equal(f.view(np.int32), ref.numpy().view(np.int32))


def _view(ptr, shape, ctype=ctypes.c_float):
    n = int(np.prod(shape))
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).reshape(shape)


class _StubLib:
    """The kernel library for the card path on CPU tensors: the warp launch
    runs `warp_twin` on the memory it is given; the other launches of the
    two-launch route do nothing but a finalize that reports rms 0. Every
    call is recorded."""

    def __init__(self):
        self.calls = []

    def srcfd_rb_small_max_cells(self):
        return 5888

    def __getattr__(self, name):
        if not name.startswith("srcfd_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            if name == "srcfd_rb_sor_warp":
                self.warp(*args)
            elif name == "srcfd_rms_finalize":
                _view(args[3], (1,))[0] = 0.0
            return 0

        return call

    def warp(self, addr, p, out, e, n, w, s, state, stream):
        prm = pk.Params.from_address(addr)
        assert (prm.reset_ratio, prm.ratio, prm.patience, prm.min_checks) == (
            F32(STALL_RESET_RATIO), F32(STALL_RATIO), STALL_PATIENCE, STALL_MIN_CHECKS)
        nx2, ny2 = prm.nx2, prm.ny2
        coef = (prm.inv_dx2, prm.inv_dy2, prm.volp, prm.sor, prm.inv_ap, prm.ap_d, prm.mode)
        flux = [_view(a, (nx2 - 2, ny2 - 2)) for a in (e, n, w, s)]
        f, it, r = warp_twin(_view(p, (nx2, ny2)), *flux, nx2, ny2, coef, prm.rhodt,
                             prm.tol, prm.max_iter, prm.check_every)
        _view(out, (nx2, ny2))[:] = f
        _view(state, (1,), ctypes.c_int32)[0] = it
        _view(state + 4, (1,))[0] = r


def _problem(seed, nx, ny, lx=10.0, ly=3.0):
    rng = np.random.default_rng(seed)
    u, v = (torch.tensor(rng.standard_normal((nx + 2, ny + 2)) * 0.1,
                         dtype=torch.float32) for _ in range(2))
    p = torch.tensor(rng.standard_normal((nx + 2, ny + 2)) * 0.01, dtype=torch.float32)
    dx, dy = lx / nx, ly / ny
    return p, face_fluxes(u, v, dx, dy), dict(dx=dx, dy=dy, dt=2e-3, rho=1.0,
                                               volp=dx * dy)


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(kernel_lib, "load_library", lambda: lib)
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda device: 0)
    checked = []

    def check_field(t, kernel, shape=None):
        # kernel_lib.check_field on a CPU tensor, but for its device
        checked.append((t, shape))
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"the {kernel} kernel does not take {t.dtype} {tuple(t.shape)}")

    monkeypatch.setattr(kernel_lib, "check_field", check_field)
    lib.checked = checked
    # the warp route's count and rms in pinned host memory: plain host
    # memory here
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: empty(*a, **k))
    # what the host must not do on the warp route: build b, copy p
    host = {"rhs": 0, "clone": 0}
    rhs, clone = pk.rhs, torch.Tensor.clone

    def counted_rhs(*a, **k):
        host["rhs"] += 1
        return rhs(*a, **k)

    def counted_clone(self, *a, **k):
        host["clone"] += 1
        return clone(self, *a, **k)

    monkeypatch.setattr(pk, "rhs", counted_rhs)
    monkeypatch.setattr(torch.Tensor, "clone", counted_clone)
    lib.host = host
    monkeypatch.setattr(pk.solve_pressure_kernel, "launches", 0)
    monkeypatch.setattr(pk.solve_pressure_kernel, "routes", dict.fromkeys(pk.ROUTES, 0))
    return lib


@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("nx,ny,tol,max_iter", [(10, 10, 0.0, 64), (10, 10, 1e-4, 1000),
                                                (20, 20, 0.0, 9), (30, 5, 0.0, 16)])
def test_card_path_takes_the_warp_route_in_one_launch(stub, divide, nx, ny, tol, max_iter):
    p, ff, geo = _problem(nx + ny, nx, ny)
    kw = dict(geo, tol=tol, max_iter=max_iter, check_every=8, sor=1.0, divide=divide)
    out, count, rms = pk.card_solve(p, ff, **kw)
    launches = [c for c in stub.calls if c[0] != "srcfd_stream_sync"]
    assert [c[0] for c in launches] == ["srcfd_rb_sor_warp"]
    assert [c[0] for c in stub.calls[1:]] == ["srcfd_stream_sync"]
    addr, *ptrs, state, stream = launches[0][1]
    assert ptrs == [p.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in ff)]
    prm = pk.Params.from_address(addr)
    assert (prm.nx2, prm.ny2, prm.mode, prm.max_iter, prm.check_every) == (
        nx + 2, ny + 2, int(divide), max_iter, 8)
    assert prm.rhodt == F32(geo["rho"] / geo["dt"]) and prm.tol == F32(tol)
    assert stub.host == {"rhs": 0, "clone": 0}
    # p checked as a padded field, each flux at the interior's shape
    assert [(t.data_ptr(), s) for t, s in stub.checked] == [(p.data_ptr(), None)] + [
        (t.data_ptr(), (nx, ny)) for t in ff]
    assert pk.solve_pressure_kernel.launches == 1
    assert pk.solve_pressure_kernel.routes == {"warp": 1, "block": 0, "two_launch": 0}
    # the twin is the plain version's arithmetic: equal field bits and count
    ref, n_ref = pk.solve_pressure_plain(p, ff, **kw)
    assert count == n_ref and torch.equal(out, ref)
    if tol == 0.0:
        assert count == -(-max_iter // 8) * 8
    else:
        assert 0.0 < rms < tol


def test_card_path_checks_the_fluxes_in_full_when_one_is_off(stub):
    """A flux that check_field refuses (strides, shape, type) raises
    before any launch, and no route is counted."""
    p, ff, geo = _problem(5, 10, 10)
    kw = dict(geo, tol=0.0, max_iter=8)
    for bad in (ff._replace(n=ff.n.T.contiguous().T), ff._replace(w=ff.w[:, :-1].contiguous()),
                ff._replace(s=ff.s.double())):
        stub.checked.clear()
        with pytest.raises(ValueError):
            pk.card_solve(p, bad, **kw)
        assert stub.checked[-1][1] == (10, 10)
    assert not stub.calls and pk.solve_pressure_kernel.launches == 0
    assert pk.solve_pressure_kernel.routes == dict.fromkeys(pk.ROUTES, 0)


def test_card_path_routes_the_larger_sizes(stub):
    p, ff, geo = _problem(3, 40, 40)
    kw = dict(geo, tol=1e-6, max_iter=64, check_every=8, sor=1.0, divide=False)
    pk.card_solve(p, ff, **kw)
    assert [c[0] for c in stub.calls] == ["srcfd_rb_sor_loop_small"]
    assert stub.host == {"rhs": 1, "clone": 1}
    p, ff, geo = _problem(4, 80, 80)
    out, count, rms = pk.card_solve(p, ff, **dict(kw, check_every=2))
    assert [c[0] for c in stub.calls[1:]] == ["srcfd_rb_partials"] + [
        "srcfd_rb_half_sweep"] * 4 + ["srcfd_rms_finalize"]
    assert count == 2
    assert pk.solve_pressure_kernel.launches == 1 + 5
    assert pk.solve_pressure_kernel.routes == {"warp": 0, "block": 1, "two_launch": 1}


def test_warp_twin_matches_the_plain_version_on_a_stalled_solve():
    """On the BFS 10x10 spacing at tol 1e-6 the loop stalls at the float32
    floor; the twin sums in the kernel's order, so its count could take
    another check there than the plain loop's, but every field it passes
    through is the plain version's at the same sweep."""
    p, ff, geo = _problem(11, 10, 10)
    f, it, rms = warp_twin(p.numpy(), *(t.numpy() for t in ff), 12, 12,
                           _coef(geo, 10, 10, False), geo["rho"] / geo["dt"], 1e-6,
                           1000, 8)
    assert it < 1000 and rms >= F32(1e-6)
    ref, n_ref = pk.solve_pressure_plain(p, ff, **geo, tol=0.0, max_iter=it)
    assert n_ref == it and np.array_equal(f.view(np.int32), ref.numpy().view(np.int32))
