"""The fused streamed V-cycle passes (`csrc/stream_pass.cu`,
`ops/stream_pass.py`), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
Here:
- the plan at the main path's shape (2048^2, n = 4) and at ragged ones:
  strips, row strips, warps, the b ring and the shared memory; the budget
  past which the staged form runs (n 7 for pass A, 8 for pass B: the
  halo of 16 columns holds 2n + 2 and 2n) and the plan's refusals; the
  column band's fit; the C constants and the parameter block's layout
  read from the source;
- `pass_twin`, a numpy float32 transcription of the kernel's schedule:
  per warp task the strip of columns with its halo (zeros beyond what it
  loads), the row march with half-sweep h on row k - h, the active cells
  of parity k, the row ranges of each half-sweep, the entry tree in its
  4-row buffer and lane steps, the restriction's running sums, the
  column band from one restricted row, and the last block's sum in 128
  threads. It is held bit-equal to `staged`, a transcription of the staged
  launch sequence (the out-of-place entry half-sweep with
  `srcfd_block_sum`'s partials, in-place half-sweeps, `srcfd_rms_finalize`,
  `sm_restrict_rows`, `mg_col_transfer`; pass B: `mg_row_transfer` and
  the half-sweeps), at <= 64^2 on the four geometries of
  tests/test_torch_stream.py and n 1, 2 and 4, on the kernel's own plan and
  on a plan of 32-column strips and 8- or 16-row strips (so that strip
  edges fall inside the grid); a column halo or a row warm-up one short of
  what n needs makes it differ;
- the staged transcription against the module's plain versions
  (`stream_pass_a_plain`, `stream_pass_b_plain`): x and the rms within a
  few ulp, the level-1 right-hand side within 1e-6 of its largest value
  (the plain column restriction is a matrix product).
The JAX parity of the streamed V-cycle stays in tests/test_torch_stream.py.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu_torch.ops import stream_kernels as sk
from sr_for_cfd_tpu_torch.ops import stream_pass as sp

torch.set_num_threads(1)

SRC = Path(sp.__file__).parent.parent / "csrc" / "stream_pass.cu"
f32 = np.float32

# tests/test_torch_stream.py:GEOMETRIES
GEOMETRIES = [
    (64, 64, 1.0, 1.0, "isotropic"),
    (72, 64, 1.0, 1.0, "ragged final slab"),
    (64, 48, 10.0, 3.0, "semi-coarsen y (BFS anisotropy)"),
    (48, 64, 3.0, 10.0, "semi-coarsen x"),
]


# ---- the plan and the source ----------------------------------------------


def test_constants_and_parameter_block_are_the_kernel_source():
    src = SRC.read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert define("SP_WARPS") == sp.WARPS
    assert define("SP_STRIP") == sp.STRIP
    assert define("SP_HALO") == sp.HALO
    assert define("SP_PREFETCH") == sp.PREFETCH
    assert define("SP_BAND") == sp.BAND
    assert define("SP_MAX_A") == sp.MAX_N["a"] and define("SP_MAX_B") == sp.MAX_N["b"]
    smem = re.search(r"#define SP_SMEM_MAX \((\d+) \* 1024\)", src)
    assert int(smem.group(1)) * 1024 == sp.SMEM_MAX
    body = re.search(r"struct StreamPassParams \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        words = decl.replace(",", " ").replace("const ", "").split()
        if not words:
            continue
        kind = {"float*": ctypes.c_void_p, "unsigned*": ctypes.c_void_p,
                "int*": ctypes.c_void_p, "int": ctypes.c_int,
                "float": ctypes.c_float}[words[0]]
        fields += [("pass_" if name == "pass" else name, kind) for name in words[1:]]
    assert fields == sp.Params._fields_
    assert ctypes.sizeof(sp.Params) == 144


@pytest.mark.parametrize("pass_", ["a", "b"])
def test_plan_of_the_main_path(pass_):
    """2048^2, n = 4: 22 strips of 96 columns x 64 row strips of 32, 1,408
    warps in 352 blocks; the block's shared memory under the limit the
    library allows, and four blocks an SM."""
    plan = sp.stream_plan(2048, 2048, 4, pass_)
    assert (plan.n_strips, plan.n_chunks, plan.n_tasks, plan.blocks) == (22, 64, 1408, 352)
    assert plan.n_strips * sp.OWN >= 2048 > (plan.n_strips - 1) * sp.OWN
    assert (plan.gx, plan.gy, plan.n_part) == (64, 256, 64 * 256)
    assert plan.ring == (13 if pass_ == "a" else 12)
    assert plan.smem == (49664 if pass_ == "a" else 49152) <= sp.SMEM_MAX
    # four blocks an SM (the kernels' launch bounds) fit its 228 KB of
    # shared memory, 1 KB a block reserved
    assert 4 * (plan.smem + 1024 + 1040) <= 233472


@pytest.mark.parametrize("shape", [(1030, 1542), (48, 48), (2048, 1024), (1024, 2048)])
def test_plan_covers_ragged_levels(shape):
    nf, mf = shape
    for pass_ in ("a", "b"):
        plan = sp.stream_plan(nf, mf, 4, pass_)
        assert plan.n_strips * sp.OWN >= mf > (plan.n_strips - 1) * sp.OWN
        assert plan.n_chunks * plan.rows >= nf > (plan.n_chunks - 1) * plan.rows
        assert plan.n_tasks <= plan.blocks * sp.WARPS < plan.n_tasks + sp.WARPS


def test_budget_and_refusals():
    """The halo of 16 columns holds n <= 7 sweeps in pass A (2n + 2) and
    n <= 8 in pass B (2n); the first n past it, and n < 1, have no plan
    (the wrappers run it on the staged form); odd sides and row strips that
    are not multiples of 8 are refused."""
    assert [n for n in range(0, 20) if sp.fits("a", n)] == list(range(1, 8))
    assert [n for n in range(0, 20) if sp.fits("b", n)] == list(range(1, 9))
    assert all(sp.smem_bytes(p, sp.MAX_N[p]) <= sp.SMEM_MAX for p in ("a", "b"))
    for pass_, n in (("a", 8), ("b", 9), ("a", 0)):
        with pytest.raises(ValueError):
            sp.stream_plan(64, 64, n, pass_)
    for kw in (dict(nf=63, mf=64), dict(nf=64, mf=62 + 1), dict(rows=12), dict(rows=0)):
        args = dict(nf=64, mf=64, n=2, pass_="a", rows=32)
        args.update(kw)
        with pytest.raises(ValueError):
            sp.stream_plan(args["nf"], args["mf"], args["n"], args["pass_"], args["rows"])
    with pytest.raises(ValueError):
        sp.stream_plan(64, 64, 2, "c")


@pytest.mark.parametrize("mf", [48, 64, 1542, 2048])
def test_column_band_fits_the_strips(mf):
    """The level-1 column restriction's band (exact halving: [2J-1, 2J+3))
    lies inside the residual of the strip that owns J, for every n pass A
    takes; one more sweep than the halo holds does not fit."""
    from sr_for_cfd_tpu_torch.ops.multigrid import _resize_matrix

    mat = _resize_matrix(mf, mf // 2).T  # (mf, mc)
    nz = (mat != 0).T
    lo = nz.argmax(axis=1)
    hi = nz.shape[1] - nz[:, ::-1].argmax(axis=1)
    for n in range(1, sp.MAX_N["a"] + 1):
        assert sp.band_fits(sp.stream_plan(64, mf, n, "a"), lo, hi)
    over = sp.stream_plan(64, mf, 7, "a")._replace(n=8)
    assert not sp.band_fits(over, lo, hi)


# ---- float32 transcriptions ------------------------------------------------


def _fma(a, b, c):
    """fmaf: the product exact in float64, one rounding of the sum (to
    float64, then float32)."""
    return f32(np.float64(a) * np.float64(b) + np.float64(c))


def _lap5(c, e, w, no, so, k):
    """mg_ops.cuh:mg_lap5 in its order (k: inv_dx2, inv_dy2, volp)."""
    inv_dx2, inv_dy2, volp = k
    return volp * ((e - f32(2.0) * c + w) * inv_dx2 + (no - f32(2.0) * c + so) * inv_dy2)


def _lap_grid(x, k):
    """mg_lap over a whole (n, m) level, zero exterior."""
    z = np.zeros((x.shape[0] + 2, x.shape[1] + 2), f32)
    z[1:-1, 1:-1] = x
    return _lap5(x, z[2:, 1:-1], z[:-2, 1:-1], z[1:-1, 2:], z[1:-1, :-2], k)


def _block_sum(v):
    """srcfd_block_sum over a (..., 8, 32) block: t = x + 32 y, steps 128 .. 1."""
    sh = v.reshape(v.shape[:-2] + (256,)).copy()
    s = 128
    while s:
        sh[..., :s] = sh[..., :s] + sh[..., s:2 * s]
        s //= 2
    return sh[..., 0]


def _fixed_sum(x):
    """srcfd_fixed_sum of x by 256 threads: thread t adds x[t], x[t + 256],
    ..., then srcfd_block_sum."""
    acc = np.zeros(256, f32)
    for k in range(0, len(x), 256):
        part = x[k:k + 256]
        acc[:len(part)] = acc[:len(part)] + part
    return _block_sum(acc.reshape(8, 32))


class Level(object):
    """What a pass reads of a StreamLevels, as float32."""

    def __init__(self, lv, n):
        self.nf, self.mf, self.nc, self.mc = lv.nf, lv.mf, lv.nc, lv.mc
        self.cx, self.cy = lv.coarsen_x, lv.coarsen_y
        self.k = tuple(f32(c) for c in lv.lap_coef)
        self.inv_ap = f32(lv.inv_ap)
        self.norm_in, self.norm_bd = f32(lv.norm_in), f32(lv.norm_bd)
        self.n = n
        band = lv.plan.col_restrict[0] if lv.coarsen_y else None
        self.band = None if band is None else tuple(t.numpy() for t in band)


def staged_a(x, b, L):
    """Pass A's staged launches: (y, b1, partials, rms)."""
    nf, mf, k = L.nf, L.mf, L.k
    i, j = np.indices((nf, mf))
    red = (i + j) % 2 == 0
    # sm_entry_half: the red half out of place, r^2 of every cell
    r = b - _lap_grid(x, k)
    y = np.where(red, x + r * L.inv_ap, x).astype(f32)
    gx, gy = -(-mf // 32), -(-nf // 8)
    t = np.zeros((gy * 8, gx * 32), f32)
    t[:nf, :mf] = r * r
    partials = _block_sum(t.reshape(gy, 8, gx, 32).transpose(0, 2, 1, 3)).reshape(-1)
    for h in range(1, 2 * L.n):  # mg_smooth_half, in place
        r = b - _lap_grid(y, k)
        y = np.where(red == (h % 2 == 0), y + r * L.inv_ap, y).astype(f32)
    rms = np.sqrt(_fixed_sum(partials) / f32(nf * mf))
    r = b - _lap_grid(y, k)  # sm_restrict_rows
    if L.cx:
        z = np.zeros((nf + 2, mf), f32)
        z[1:-1] = r
        u = z[0:-3:2] + f32(3.0) * z[1:-2:2]
        u = u + f32(3.0) * z[2:-1:2]
        u = u + z[3::2]
        norm = np.full((L.nc, 1), L.norm_in, f32)
        norm[0] = norm[-1] = L.norm_bd
        rows = u * norm
    else:
        rows = r * L.norm_in
    if not L.cy:
        return y, rows, partials, rms
    mat, lo, hi = L.band  # mg_col_transfer
    b1 = np.zeros((rows.shape[0], L.mc), f32)
    for J in range(L.mc):
        acc = np.zeros(rows.shape[0], f32)
        for jj in range(lo[J], hi[J]):
            acc = _fma(rows[:, jj], mat[jj, J], acc)
        b1[:, J] = acc * f32(1.0)
    return y, b1, partials, rms


def staged_b(x, b, e, L):
    """Pass B's staged launches: mg_row_transfer (accumulate), then the
    half-sweeps in place."""
    nf, mf = L.nf, L.mf
    if L.cx:
        I = np.arange(nf)
        kk = I >> 1
        nb = np.where(I & 1, np.minimum(kk + 1, L.nc - 1), np.maximum(kk - 1, 0))
        v = f32(0.75) * e[kk] + f32(0.25) * e[nb]
    else:
        v = e
    y = x + v * f32(1.0)
    i, j = np.indices((nf, mf))
    red = (i + j) % 2 == 0
    for h in range(2 * L.n):
        r = b - _lap_grid(y, L.k)
        y = np.where(red == (h % 2 == 0), y + r * L.inv_ap, y).astype(f32)
    return y


def _row_ops(row):
    """(left, right) neighbours of a strip row; zeros beyond the strip."""
    left = np.concatenate([[f32(0)], row[:-1]])
    right = np.concatenate([row[1:], [f32(0)]])
    return left, right


def pass_twin(x, b, e, L, pass_, own=sp.OWN, halo=sp.HALO, rows=sp.ROWS, row_halo=None):
    """The fused kernel's schedule (see the module docstring); returns
    (y, b1, partials, rms) for pass A, y for pass B. `halo` columns are
    loaded on each side of the `own` ones, and raw rows start `row_halo`
    (default: what n needs) above the first owned row."""
    nf, mf, n, k = L.nf, L.mf, L.n, L.k
    a = pass_ == "a"
    H_r = sp.halo_needed(pass_, n) if row_halo is None else row_halo
    # lanes hold 4 columns from cs = c0 - (halo rounded up to 4); columns
    # farther than `halo` from the owned ones are not loaded (zeros)
    lay = -(-halo // 4) * 4
    strip_w = own + 2 * lay
    y = np.full((nf, mf), np.nan, f32)
    gx, gy = -(-mf // 32), -(-nf // 8)
    partials = np.full(gx * gy, np.nan, f32)
    b1 = np.full((L.nc if L.cx else nf, L.mc if L.cy else mf), np.nan, f32)
    zero = np.zeros(strip_w, f32)
    for strip in range(-(-mf // own)):
        c0 = strip * own
        cs = c0 - lay
        cols = cs + np.arange(strip_w)
        inn = (cols >= 0) & (cols < mf)
        loaded = inn & (cols >= c0 - halo) & (cols < c0 + own + halo)
        owned = inn & (cols >= c0) & (cols < c0 + own)
        cl = np.clip(cols, 0, mf - 1)
        for chunk in range(-(-nf // rows)):
            r0, r1 = chunk * rows, min(chunk * rows + rows, nf)
            lo_raw, hi_raw = max(r0 - H_r, 0), min(r1 - 1 + H_r, nf - 1)
            lo_h = r0 - H_r + 1
            g_lo, g_hi = max(r0 - 1, 0), min(r1, nf - 1)
            kend = g_hi + 2 * n if a else r1 + 2 * n - 2
            win = {}

            def row_of(rr):
                return win.get(rr, zero)

            def load(rr):
                if not lo_raw <= rr <= hi_raw:
                    return zero.copy()
                xv = np.where(loaded, x[rr, cl], 0).astype(f32)
                if a:
                    return xv
                if L.cx:
                    k1 = rr >> 1
                    k2 = min(k1 + 1, L.nc - 1) if rr & 1 else max(k1 - 1, 0)
                    v = f32(0.75) * e[k1, cl] + f32(0.25) * e[k2, cl]
                else:
                    v = e[rr, cl]
                return np.where(loaded, xv + np.where(loaded, v, 0) * f32(1.0), 0).astype(f32)

            def bro(rr):
                return np.where(loaded, b[rr, cl], 0).astype(f32)

            def resid(rr, up):
                c = row_of(rr)
                left, right = _row_ops(c)
                return bro(rr) - _lap5(c, row_of(rr + 1), up, right, left, k)

            tree = np.zeros((4, strip_w), f32)
            cur = np.zeros(strip_w, f32)
            nxt = np.zeros(strip_w, f32)
            raw = zero.copy()
            # the kernel's steps start at an even k0 and go in pairs (parity
            # 0, then 1): step kk's active cells are the lane columns of
            # parity (kk - k0) % 2
            k0 = (r0 - H_r - 1) // 2 * 2
            for kk in range(k0, kend + 1):
                win[kk + 1] = load(kk + 1)
                re_ = None
                if a and r0 <= kk < r1:
                    re_ = resid(kk, raw)
                    _tree_row(tree, kk, np.where(inn, re_ * re_, 0).astype(f32), nf,
                              c0, cs, own, partials, gx)
                raw = row_of(kk).copy()
                for h in range(2 * n):
                    r = kk - h
                    if kk >= lo_h + 2 * h and 0 <= r < nf:
                        act = (cols - cs) % 4 % 2 == (kk - k0) % 2
                        c = row_of(r)
                        rr_ = re_ if h == 0 and re_ is not None else resid(r, row_of(r - 1))
                        win[r] = np.where(act & inn, c + rr_ * L.inv_ap, c).astype(f32)
                g = kk - 2 * n
                if a and g_lo <= g <= g_hi:
                    t = resid(g, row_of(g - 1))
                    if not L.cx:
                        if r0 <= g < r1:
                            _emit(L, b1, g, t, owned, c0, cs, own, cols)
                    elif g & 1:
                        cur = cur + f32(3.0) * t
                        nxt = t
                        I = (g - 1) // 2
                        if g == nf - 1 and 2 * I >= r0:
                            _emit(L, b1, I, cur + f32(0.0), owned, c0, cs, own, cols)
                    else:
                        if g > 0:
                            cur = cur + t
                            I = g // 2 - 1
                            if 2 * I >= r0:
                                _emit(L, b1, I, cur, owned, c0, cs, own, cols)
                        cur = nxt + f32(3.0) * t
                q = kk - 2 * n + 1
                if r0 <= q < r1:
                    y[q, cols[owned]] = row_of(q)[owned]
    if not a:
        return y
    # the last block: 256 sums in 128 threads, then srcfd_block_sum's tree
    lo_s, hi_s = np.zeros(128, f32), np.zeros(128, f32)
    for m in range(len(partials)):
        if m % 256 < 128:
            lo_s[m % 256] = lo_s[m % 256] + partials[m]
        else:
            hi_s[m % 256 - 128] = hi_s[m % 256 - 128] + partials[m]
    sh = np.concatenate([lo_s, hi_s])
    s = 128
    while s:
        sh[:s] = sh[:s] + sh[s:2 * s]
        s //= 2
    return y, b1, partials, np.sqrt(sh[0] / f32(nf * mf))


def _tree_row(tree, kk, t, nf, c0, cs, own, partials, gx):
    """sp_entry_sum: row kk's r^2 into the 4-row tree; at row 7 of a block
    (or the level's last row, the rows past it as zeros) the lane steps."""
    y, v = kk & 7, t
    while True:
        if y < 4:
            tree[y] = v
        elif y == 4:
            tree[0] = tree[0] + v
        elif y == 5:
            tree[1] = tree[1] + v
        elif y == 6:
            tree[0] = tree[0] + (tree[2] + v)
        else:
            c = tree[0] + (tree[1] + (tree[3] + v))
            for q in range(own // 32):
                d = c[c0 + 32 * q - cs:c0 + 32 * q - cs + 32].reshape(8, 4).copy()
                for w in (4, 2, 1):
                    d[:w] = d[:w] + d[w:2 * w]
                bx = c0 // 32 + q
                if bx < gx:
                    partials[(kk >> 3) * gx + bx] = (d[0, 0] + d[0, 2]) + (d[0, 1] + d[0, 3])
            return
        if kk != nf - 1:
            return
        y, v = y + 1, np.zeros_like(t)


def _emit(L, b1, I, v, owned, c0, cs, own, cols):
    """sp_emit: the row's norm, then b1 directly or the column band from
    the restricted row (zeros beyond the strip)."""
    norm = L.norm_bd if L.cx and (I == 0 or I == L.nc - 1) else L.norm_in
    w = v * norm
    if not L.cy:
        b1[I, cols[owned]] = w[owned]
        return
    mat, lo, hi = L.band
    for J in range(c0 // 2, min(c0 // 2 + own // 2, L.mc)):
        acc = f32(0.0)
        for jj in range(lo[J], hi[J]):
            val = w[jj - cs] if 0 <= jj - cs < len(w) else f32(0.0)
            acc = _fma(val, mat[jj, J], acc)
        b1[I, J] = acc * f32(1.0)


# ---- the twin against the staged sequence ----------------------------------


def _case(nx, ny, lx, ly, n, seed=0):
    """A seeded level (x, b, the correction e) of the streamed hierarchy."""
    lv = sk.StreamLevels(nx, ny, lx / nx, ly / ny, (lx / nx) * (ly / ny), "cpu",
                         n_pre=n, n_post=n)
    g = np.random.default_rng(seed + 100 * n + nx + 3 * ny)
    x = g.standard_normal((lv.nf, lv.mf)).astype(f32)
    b = g.standard_normal((lv.nf, lv.mf)).astype(f32)
    e = g.standard_normal((lv.nc if lv.coarsen_x else lv.nf, lv.mf)).astype(f32)
    return lv, x, b, e


def _same(got, ref):
    for a_, b_ in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a_), np.asarray(b_))


PLANS = [dict(), dict(own=32, rows=16), dict(own=32, rows=8)]


@pytest.mark.parametrize("plan", PLANS, ids=["kernel plan", "32x16", "32x8"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("nx,ny,lx,ly,label", GEOMETRIES, ids=[g[-1] for g in GEOMETRIES])
def test_twin_is_bit_equal_to_the_staged_passes(nx, ny, lx, ly, label, n, plan):
    lv, x, b, e = _case(nx, ny, lx, ly, n)
    L = Level(lv, n)
    ref = staged_a(x, b, L)
    _same(pass_twin(x, b, None, L, "a", **plan), ref)
    _same([pass_twin(x, b, e, L, "b", **plan)], [staged_b(x, b, e, L)])


@pytest.mark.parametrize("pass_", ["a", "b"])
@pytest.mark.parametrize("short", ["columns", "rows"])
def test_a_halo_one_short_fails_the_twin(pass_, short):
    """With the column halo or the row warm-up one short of what n = 2
    sweeps need (2n + 2 in pass A, 2n in pass B), strip and row-strip
    edges inside the grid get other values."""
    lv, x, b, e = _case(64, 64, 1.0, 1.0, 2, seed=5)
    L = Level(lv, 2)
    need = sp.halo_needed(pass_, 2)
    ref = staged_a(x, b, L) if pass_ == "a" else [staged_b(x, b, e, L)]

    def twin(**kw):
        out = pass_twin(x, b, e, L, pass_, own=32, rows=16, **kw)
        return out if pass_ == "a" else [out]

    _same(twin(halo=need, row_halo=need), ref)
    kw = dict(halo=need - 1) if short == "columns" else dict(halo=need, row_halo=need - 1)
    with pytest.raises(AssertionError):
        _same(twin(**kw), ref)


@pytest.mark.parametrize("nx,ny,lx,ly,label", GEOMETRIES, ids=[g[-1] for g in GEOMETRIES])
def test_staged_transcription_matches_the_plain_passes(nx, ny, lx, ly, label):
    """The staged transcription against `stream_pass_a_plain` and
    `stream_pass_b_plain` on the same inputs (they round the same
    expressions, apart from the plain column restriction's matrix product
    and the plain rms's sum)."""
    lv, x, b, e = _case(nx, ny, lx, ly, 2, seed=9)
    L = Level(lv, 2)
    y, b1, _, rms = staged_a(x, b, L)
    ty, tb1, trms = sk.stream_pass_a_plain(torch.from_numpy(x), torch.from_numpy(b), lv)
    np.testing.assert_allclose(y, ty.numpy(), rtol=0, atol=4e-7 * np.abs(y).max())
    np.testing.assert_allclose(b1, tb1.numpy(), rtol=0, atol=1e-6 * np.abs(b1).max())
    np.testing.assert_allclose(rms, trms.item(), rtol=1e-6)
    yb = staged_b(x, b, e, L)
    tyb = sk.stream_pass_b_plain(torch.from_numpy(x), torch.from_numpy(b),
                                 torch.from_numpy(e), lv)
    np.testing.assert_allclose(yb, tyb.numpy(), rtol=0, atol=4e-7 * np.abs(yb).max())


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the fused wrappers launch nothing: their plain
    versions run, whatever n."""
    lv, x, b, e = _case(48, 64, 3.0, 10.0, 2)
    before = (sk.stream_pass_a.launches, sk.stream_pass_b.launches)
    xt, bt, et = (torch.from_numpy(a_) for a_ in (x, b, e))
    out = sk.stream_pass_a(xt, bt, lv)
    for a_, b_ in zip(out, sk.stream_pass_a_plain(xt, bt, lv)):
        assert torch.equal(a_, b_)
    assert torch.equal(sk.stream_pass_b(xt, bt, et, lv), sk.stream_pass_b_plain(xt, bt, et, lv))
    assert (sk.stream_pass_a.launches, sk.stream_pass_b.launches) == before
