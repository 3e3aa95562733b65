"""The V-cycle's coarse tail and its launch sequence (`ops/mg_kernels.py`),
on the CPU.

The tail kernel (`csrc/mg_vcycle.cu` mg_tail_kernel) and the CUDA graph run
only on the card (tests/test_torch_cuda.py, chip_smoke.py). Here:
- the rule that picks the tail level t, and the tail's shared bytes;
- the launches of one cycle, recorded from a stub in place of the kernel
  library: the tail form must be the stage form with the calls of levels
  >= t replaced by one tail launch, with the same per-level arguments;
- the tail's plain twin (`multigrid._Ops.v_cycle(x, b, t)`) against the
  JAX package's `make_level_ops(...).v_cycle(x, b, t)`, float32, within
  1e-5 of max|x|: the TPU's transfers are a bf16x3 split (`mxu_dot_f32`),
  ~2^-18 relative off a float32 product; the port's are true float32.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.ops.pallas_mg import make_level_ops
from sr_for_cfd_tpu.ops.pallas_mg import plan_hierarchy as jax_plan_hierarchy
from sr_for_cfd_tpu_torch.ops import kernel_lib
from sr_for_cfd_tpu_torch.ops import mg_kernels as mk
from sr_for_cfd_tpu_torch.ops.multigrid import _Ops, level_setup

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

# (nx, ny, lx, ly, top): the hybrid's 400^2 BFS fine grid, the 2048^2
# cavity's level-1 correction, and an odd grid whose banded row transfers
# run on the stages above the tail
HIERARCHIES = {
    "bfs400": (400, 400, 10.0, 3.0, 0),
    "cavity2048_level1": (2048, 2048, 1.0, 1.0, 1),
    "odd1001x999_banded_rows": (1001, 999, 1.0, 1.0, 0),
}
# kernels per cycle, stage form and tail form
KERNELS_PER_CYCLE = {
    "bfs400": (206, 64),
    "cavity2048_level1": (228, 86),
    "odd1001x999_banded_rows": (229, 87),
}


def _setup(nx, ny, lx, ly):
    dx, dy = lx / nx, ly / ny
    return (nx, ny, dx, dy, dx * dy)


def test_tail_level_of_the_main_paths():
    bfs = level_setup(*_setup(400, 400, 10.0, 3.0)).sizes
    assert bfs[3:] == ((100, 50), (50, 25), (25, 12), (12, 6))
    assert mk.tail_level(bfs) == 3
    assert 4 * mk.tail_layout(bfs, 3)[1] == 92252
    cavity = level_setup(*_setup(2048, 2048, 1.0, 1.0)).sizes
    assert cavity[5:] == ((64, 64), (32, 32), (16, 16), (8, 8))
    assert mk.tail_level(cavity, top=1) == 5
    assert 4 * mk.tail_layout(cavity, 5)[1] == 75776


def test_tail_constants_are_the_kernel_source():
    src = (Path(mk.__file__).parent.parent / "csrc" / "mg_vcycle.cu").read_text()
    budget = re.search(r"#define MG_TAIL_SMEM_BUDGET \((\d+) \* 1024\)", src)
    levels = re.search(r"#define MG_TAIL_MAX_LEVELS (\d+)", src)
    assert int(budget.group(1)) * 1024 == mk.TAIL_SMEM_BUDGET
    assert int(levels.group(1)) == mk.TAIL_MAX_LEVELS
    # under the 227 KB (232,448 bytes) a block can have, with room for the
    # level table in static shared memory
    assert mk.TAIL_SMEM_BUDGET + 4096 <= 232448


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tail_fits_every_seeded_hierarchy(seed):
    """Grids from 8 to 2048 cells a side on domains up to 10:1: t is the
    first level at or below top whose tail fits, and it fits."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        nx, ny = (int(v) for v in rng.integers(8, 2049, size=2))
        lx, ly = (float(v) for v in rng.choice([1.0, 3.0, 10.0], size=2))
        sizes = level_setup(*_setup(nx, ny, lx, ly)).sizes
        for top in range(min(2, len(sizes))):
            t = mk.tail_level(sizes, top)
            assert t is not None, sizes
            layout, floats = mk.tail_layout(sizes, t)
            assert 4 * floats <= mk.TAIL_SMEM_BUDGET
            assert len(layout) == len(sizes) - t <= mk.TAIL_MAX_LEVELS
            if t > top:  # one level more would not fit
                assert 4 * mk.tail_layout(sizes, t - 1)[1] > mk.TAIL_SMEM_BUDGET
            # the arrays do not overlap and end at the total
            spans = sorted((o, o + size) for (n, m), offs, nxt in zip(
                sizes[t:], layout, list(sizes[t + 1:]) + [None])
                for o, size in zip(offs, (n * m, n * m,
                                          n * m if nxt else 0,
                                          nxt[0] * m if nxt and nxt[0] != n
                                          and nxt[1] != m else 0)) if size)
            assert spans[0][0] == 0 and spans[-1][1] == floats
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


class _StubLib:
    """Records every call of the kernel library; each returns 0 (success),
    srcfd_mg_partials a partial count."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("srcfd_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return 4 if name == "srcfd_mg_partials" else 0

        return call


def _symbols(cyc):
    """data pointer -> (name, level) of the cycle's buffers, the plan's
    bands and the tail's host arrays."""
    sym = {}
    for kind in ("x", "b", "r", "tmp"):
        for lvl, t in enumerate(getattr(cyc, kind)):
            if t is not None:
                sym[t.data_ptr()] = (f"{kind}{lvl}", lvl)
    if cyc.top == 0:
        sym[cyc.partials.data_ptr()] = ("partials", 0)
        sym[cyc.rms_dev.data_ptr()] = ("rms", 0)
    elif cyc.e is not None:
        sym[cyc.e.data_ptr()] = ("e", cyc.top - 1)
    for kind in ("row_restrict", "col_restrict", "row_prolong", "col_prolong"):
        for lvl, bm in enumerate(getattr(cyc.plan, kind)):
            if bm is not None:
                for part in ("mat", "lo", "hi"):
                    sym[getattr(bm, part).data_ptr()] = (f"{kind}{lvl}.{part}", lvl)
    if cyc.t is not None:
        for part, a in zip("ifp", cyc.tail_args[:3]):
            sym[a.ctypes.data] = (f"tail_{part}", cyc.t)
    return sym


def _record(monkeypatch, plan, top, tail):
    stub = _StubLib()
    monkeypatch.setattr(kernel_lib, "load_library", lambda: stub)
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda device: 0)
    counter = mk._Tally()
    cyc = mk._Cycle(plan, "cpu", 4, 4, 1.5, 40, counter=counter, top=top,
                    _tail=tail, _graph=False)
    stub.calls.clear()
    cyc.run()
    sym = _symbols(cyc)
    calls = [(name, tuple(sym.get(a, (a, None)) if isinstance(a, int) and a > 4096
                          else (a, None) for a in args))
             for name, args in stub.calls]
    return cyc, calls, counter.launches


@pytest.mark.parametrize("name", list(HIERARCHIES))
def test_tail_form_replaces_the_tail_levels_by_one_launch(name, monkeypatch):
    nx, ny, lx, ly, top = HIERARCHIES[name]
    plan = mk.plan_hierarchy(*_setup(nx, ny, lx, ly), 8, "cpu")
    stage_cyc, stage, n_stage = _record(monkeypatch, plan, top, tail=False)
    cyc, tail, n_tail = _record(monkeypatch, plan, top, tail=True)
    t = cyc.t
    assert stage_cyc.t is None and t is not None and t > top
    # banded row transfers run on the stages above t only in the odd grid
    banded_above = any(mode == mk.ROW_BAND for mode in plan.row_mode[:t])
    assert banded_above == (name == "odd1001x999_banded_rows")

    def of_tail(call):
        """A call of v_cycle(t): every buffer it names is of a level >= t
        (the memset of x[t] before it is v_cycle(t - 1)'s)."""
        levels = [lvl for _, lvl in call[1] if lvl is not None]
        zero_xt = call[0] == "srcfd_mg_zero" and call[1][0][0] == f"x{t}"
        return bool(levels) and min(levels) >= t and not zero_xt

    inside = [i for i, c in enumerate(stage) if of_tail(c)]
    i0, i1 = inside[0], inside[-1] + 1
    assert inside == list(range(i0, i1))  # one contiguous run: v_cycle(t)
    assert tail[:i0] == stage[:i0] and tail[i0 + 1:] == stage[i1:]
    name_t, args = tail[i0]
    assert name_t == "srcfd_mg_tail"
    assert [a[0] for a in args] == [f"x{t}", f"b{t}", len(plan.setup.sizes) - t,
                                    "tail_i", "tail_f", "tail_p", 4, 4, 40,
                                    cyc.tail_args[3], 0]
    assert (n_stage, n_tail) == KERNELS_PER_CYCLE[name]
    kernels = [c for c in tail if c[0] not in ("srcfd_mg_zero", "srcfd_mg_partials")]
    assert len(kernels) == n_tail

    # the tail's per-level arguments are the stage form's, as float32
    iprm, fprm, pprm, _ = cyc.tail_args
    sizes = plan.setup.sizes
    for k, lvl in enumerate(range(t, len(sizes))):
        smooth = [c[1] for c in stage if c[0] == "srcfd_mg_smooth_half"
                  and c[1][0][0] == f"x{lvl}"]
        n, m, inv_dx2, inv_dy2, volp, inv_ap = (a[0] for a in smooth[0][2:8])
        assert tuple(iprm[8 * k:8 * k + 2]) == (n, m) == sizes[lvl]
        np.testing.assert_array_equal(
            fprm[5 * k:5 * k + 4], np.float32([inv_dx2, inv_dy2, volp, inv_ap]))
        last = lvl + 1 == len(sizes)
        assert len(smooth) == 2 * (40 if last else 8)
        if not last:
            assert iprm[8 * k + 2] == plan.row_mode[lvl]
            assert fprm[5 * k + 4] == np.float32(plan.setup.scales[lvl])
            for j, kind in enumerate(("row_restrict", "row_prolong",
                                      "col_restrict", "col_prolong")):
                bm = getattr(plan, kind)[lvl]
                want = [0, 0, 0] if bm is None else [
                    bm.mat.data_ptr(), bm.lo.data_ptr(), bm.hi.data_ptr()]
                assert list(pprm[12 * k + 3 * j:12 * k + 3 * j + 3]) == want


@pytest.mark.parametrize("name", ["bfs400", "cavity2048_level1"])
def test_tail_plain_twin_matches_jax_level_ops(name):
    """One V-cycle from level t down and back: the port's plain level
    operators against the TPU kernel's `make_level_ops`, run as plain JAX
    on the CPU, on the same numpy-seeded float32 inputs."""
    nx, ny, lx, ly, top = HIERARCHIES[name]
    geo = _setup(nx, ny, lx, ly)
    setup = level_setup(*geo)
    t = mk.tail_level(setup.sizes, top)
    rng = np.random.default_rng(nx + t)
    x = rng.standard_normal(setup.sizes[t]).astype(np.float32)
    b = rng.standard_normal(setup.sizes[t]).astype(np.float32)
    jplan = jax_plan_hierarchy(*geo)
    _, _, v_cycle = make_level_ops([jnp.asarray(m) for m in jplan.mats], jplan,
                                   n_pre=4, n_post=4, sor=1.5, coarsest_sweeps=40)
    ref = np.asarray(jax.jit(lambda x, b: v_cycle(x, b, t))(jnp.asarray(x),
                                                            jnp.asarray(b)))
    ops = _Ops(setup, torch.float32, "cpu", 4, 4, 1.5, 40)
    out = ops.v_cycle(torch.tensor(x), torch.tensor(b), t).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert not np.allclose(out, x)  # the cycle did something
