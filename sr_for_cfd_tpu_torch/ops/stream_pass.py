"""Host side of the fused streamed V-cycle passes (`csrc/stream_pass.cu`).

Pass A (n_pre sweeps, the entry rms, the residual and its restriction) and
pass B (the prolonged correction, n_post sweeps) each run in one launch:
a warp marches down a strip of `rows` rows of OWN columns, loading HALO
more on each side, with the half-sweeps one row apart (a wavefront) and
the columns in registers (see the kernel's note).

`stream_plan(nf, mf, n, pass_, rows)`: the warps' tasks (column strips x
row strips), blocks of WARPS tasks, the b ring's slots and the dynamic
shared memory of a block. `fits(pass_, n)` says whether n sweeps have a
plan: the halo holds 2n + 2 columns in pass A (n <= 7) and 2n in pass B
(n <= 8). A larger n runs on the staged form (`ops/stream_kernels.py`).
`FusedPass` owns one pass's parameter block and what it points at.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import kernel_lib

# csrc/stream_pass.cu: SP_WARPS, SP_STRIP, SP_HALO, SP_OWN, SP_PREFETCH,
# SP_BAND, SP_MAX_A, SP_MAX_B, SP_SMEM_MAX
WARPS = 4
STRIP = 128
HALO = 16
OWN = STRIP - 2 * HALO
PREFETCH = 3
BAND = 4
MAX_N = {"a": 7, "b": 8}
SMEM_MAX = 96 * 1024
# rows a warp owns by default: a multiple of 8 (the entry rms's staged
# blocks) that gives the 2048^2 level 22 x 64 = 1,408 warps, ~11 an SM
ROWS = 32
PASSES = ("a", "b")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def halo_needed(pass_: str, n: int) -> int:
    """Columns (and raw rows above the owned ones) a pass of n sweeps reads
    beyond what it writes: the sweeps, and in pass A the residual and the
    restriction's band."""
    return 2 * n + 2 if pass_ == "a" else 2 * n


def ring_slots(pass_: str, n: int) -> int:
    """Rows of b a warp keeps in shared memory (`sp_bslots`)."""
    return 2 * n + (2 if pass_ == "a" else 1) + PREFETCH


def smem_bytes(pass_: str, n: int) -> int:
    """Dynamic shared memory of a block (`sp_warp_floats` x WARPS)."""
    x_ring = (PREFETCH + 1) * (1 if pass_ == "a" else 3) * STRIP
    # pass A: the entry tree, one restricted row, the column band
    extra = 5 * STRIP + (OWN // 2) * (2 + BAND) if pass_ == "a" else 0
    return 4 * WARPS * (x_ring + ring_slots(pass_, n) * STRIP + extra)


def fits(pass_: str, n: int) -> bool:
    """Whether n sweeps of pass `pass_` have a fused plan."""
    return 1 <= n <= MAX_N[pass_] and halo_needed(pass_, n) <= HALO


class StreamPlan(NamedTuple):
    pass_: str
    n: int
    nf: int
    mf: int
    rows: int  # rows a warp owns (a multiple of 8)
    n_strips: int  # column strips of OWN columns
    n_chunks: int  # row strips
    ring: int
    smem: int
    gx: int  # the staged entry half-sweep's 32 x 8 grid (the partials)
    gy: int

    @property
    def n_tasks(self) -> int:
        return self.n_strips * self.n_chunks

    @property
    def blocks(self) -> int:
        return _cdiv(self.n_tasks, WARPS)

    @property
    def n_part(self) -> int:
        return self.gx * self.gy


@functools.lru_cache(maxsize=64)
def stream_plan(nf: int, mf: int, n: int, pass_: str, rows: int = ROWS) -> StreamPlan:
    """The fused pass's plan for an interior-shaped (nf, mf) level."""
    if pass_ not in PASSES:
        raise ValueError(f"pass must be one of {PASSES}, got {pass_!r}")
    if nf < 2 or mf < 2 or nf % 2 or mf % 2:
        raise ValueError(f"the fused streamed passes take even level sides, got ({nf}, {mf})")
    if rows < 8 or rows % 8:
        raise ValueError(f"rows must be a positive multiple of 8, got {rows}")
    if not fits(pass_, n):
        raise ValueError(
            f"n={n} sweeps of pass {pass_.upper()} read {halo_needed(pass_, n)} columns "
            f"beyond their strip, past the fused pass's halo of {HALO} (n <= "
            f"{MAX_N[pass_]})")
    return StreamPlan(pass_, n, nf, mf, rows, _cdiv(mf, OWN), _cdiv(nf, rows),
                      ring_slots(pass_, n), smem_bytes(pass_, n), _cdiv(mf, 32),
                      _cdiv(nf, 8))


def band_fits(plan: StreamPlan, lo: np.ndarray, hi: np.ndarray) -> bool:
    """Whether every coarse column J's band [lo[J], hi[J]) is at most BAND
    wide and lies where its strip (J // (OWN / 2)) has the residual: OWN /
    2 coarse columns a strip, the residual valid on the strip's loaded
    columns less 2n + 1 a side."""
    J = np.arange(len(lo))
    cs = (J // (OWN // 2)) * OWN - HALO
    edge = 2 * plan.n + 1
    live = hi > lo
    inside = (lo >= cs + edge) & (hi <= cs + STRIP - edge) & (hi - lo <= BAND)
    return bool(np.all(~live | inside))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Params(ctypes.Structure):
    """csrc/stream_pass.cu's StreamPassParams, field for field."""

    _fields_ = [*((n, _P) for n in ("partials", "ticket", "col_mat", "col_lo", "col_hi")),
                *((n, _I) for n in ("pass_", "n", "nf", "mf", "nc", "mc", "coarsen_x",
                                    "coarsen_y", "own", "halo", "warps", "rows",
                                    "n_strips", "n_chunks", "ring", "prefetch", "smem",
                                    "gx", "gy")),
                *((n, _F) for n in ("inv_dx2", "inv_dy2", "volp", "inv_ap", "norm_in",
                                    "norm_bd", "n_cells"))]


class FusedPass:
    """One fused pass of one streamed hierarchy on the card: its plan and
    parameter block, with the entry partials, the ticket and the column
    band it points at, owned here. `lv` is a `stream_kernels.StreamLevels`
    (its sizes, coefficients and transfer plan)."""

    def __init__(self, lv, pass_: str):
        self.lib = kernel_lib.load_library()
        n = lv.n_pre if pass_ == "a" else lv.n_post
        self.plan = stream_plan(lv.nf, lv.mf, n, pass_)
        device = lv.device
        nc = lv.nc if lv.coarsen_x else lv.nf
        mc = lv.mc if lv.coarsen_y else lv.mf
        self.out_shape = (nc, mc)
        self.partials: Optional[torch.Tensor] = None
        self.ticket: Optional[torch.Tensor] = None
        self.band = None
        ptrs = [None] * 5
        if pass_ == "a":
            self.partials = torch.zeros(self.plan.n_part, dtype=torch.float32, device=device)
            self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
            ptrs[:2] = [self.partials.data_ptr(), self.ticket.data_ptr()]
            if lv.coarsen_y:
                self.band = lv.plan.col_restrict[0]
                if not band_fits(self.plan, self.band.lo.cpu().numpy(),
                                 self.band.hi.cpu().numpy()):
                    raise ValueError("the column restriction's band is wider than the "
                                     "fused pass A's halo")
                ptrs[2:] = [t.data_ptr() for t in self.band]
        inv_dx2, inv_dy2, volp = lv.lap_coef
        p = self.plan
        self.params = Params(*ptrs, PASSES.index(pass_), n, lv.nf, lv.mf, nc, mc,
                             int(lv.coarsen_x), int(lv.coarsen_y), OWN, HALO, WARPS,
                             p.rows, p.n_strips, p.n_chunks, p.ring, PREFETCH, p.smem,
                             p.gx, p.gy, inv_dx2, inv_dy2, volp, lv.inv_ap, lv.norm_in,
                             lv.norm_bd, float(lv.nf * lv.mf))
        self.addr = ctypes.addressof(self.params)

    def __call__(self, x: torch.Tensor, y: torch.Tensor, b: torch.Tensor,
                 e: Optional[torch.Tensor] = None, b1: Optional[torch.Tensor] = None,
                 rms: Optional[torch.Tensor] = None) -> int:
        """Launch the pass on the current stream; returns the C code."""
        return self.lib.srcfd_stream_pass(
            self.addr, x.data_ptr(), y.data_ptr(), b.data_ptr(),
            None if e is None else e.data_ptr(), None if b1 is None else b1.data_ptr(),
            None if rms is None else rms.data_ptr(), kernel_lib.stream_ptr(x.device))
