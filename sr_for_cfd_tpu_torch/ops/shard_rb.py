"""Host side of the one tiled red-black kernel's fused form (`csrc/shard_rb.cu`).

The fused form runs kb whole red-black sweeps of a row block and the
residual sum of squares of the last one in one launch: the per-rank sweep
(row 9, `parallel/spmd_kernels.py`) launches it once per call, the tiled
pressure loop (row 5, `ops/tiled_kernels.py`) once per sweep with its exit
state on the card. This module gives both the launch plan and the block of
constants the C entry reads.

`shard_rb_plan(R, W, h, kb)`: output tiles of OT x OT inner cells (OT = 32
or 64), anchored at the block's inner cell (1, 1), so that each tile is
whole 32 x 32 sum tiles and the partial sums keep the one-sweep form's
order and index. Only tile rows that hold an own row (k in [h, R - h)) are
launched, one block a tile; the partials of the others count as 0. A
block loads its tile's f with a 2kb-cell halo and b with a (2kb - 1)-cell
ring into shared memory, plus the OT x OT terms: 4 * (2 L^2 + OT^2) bytes
with L = OT + 4kb, at most SMEM_BUDGET. OT is 64 where that still launches
MIN_BLOCKS tiles and fits the budget (less redundant work on the halo: at
kb = 8, 1.5x the tile's cell updates against 2.2x with OT = 32), else 32.
A plan past the budget raises: `fits(kb)` says whether a kb has one (kb <=
33), and the per-rank sweep runs a larger kb on the one-sweep form.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np

# csrc/shard_rb.cu: SHARD_RB_SMEM_BUDGET (the C entry refuses a plan past
# it) and SUM_TILE; csrc/common.cuh: SRCFD_THREADS
SMEM_BUDGET = 220 * 1024
SUM_TILE = 32
THREADS = 256
SM_COUNT = 132  # H100 SXM streaming multiprocessors
MIN_BLOCKS = SM_COUNT  # a 64-cell tile only where it still fills the card


class ShardPlan(NamedTuple):
    ot: int  # output tile side
    kb: int
    tiles_x: int  # tiles across the inner columns
    a0: int  # first tile row launched
    tiles_y: int  # tile rows launched
    smem: int  # dynamic shared bytes a block
    gx_sum: int  # the 32 x 32 sum tiles' grid over the inner cells
    gy_sum: int
    z0: int  # partials [z0, z1) are written, the rest count as 0
    z1: int

    @property
    def n_sum(self) -> int:
        return self.gx_sum * self.gy_sum

    @property
    def n_tiles(self) -> int:
        """Tiles launched, one block each."""
        return self.tiles_x * self.tiles_y


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def n_partials(R: int, W: int) -> int:
    """Partial sums of an (R, W) block: one per 32 x 32 sum tile of its
    inner cells (the one-sweep form's srcfd_shard_rb_partials)."""
    return _cdiv(W - 2, SUM_TILE) * _cdiv(R - 2, SUM_TILE)


def smem_bytes(ot: int, kb: int) -> int:
    side = ot + 4 * kb
    return 4 * (2 * side * side + ot * ot)


def fits(kb: int) -> bool:
    """Whether kb sweeps have a fused plan (on 32-cell tiles)."""
    return smem_bytes(SUM_TILE, kb) <= SMEM_BUDGET


def _tiles(R: int, W: int, h: int, ot: int):
    rows = R - 2 * h
    a0 = (h - 1) // ot
    a1 = (rows + h - 2) // ot  # tile row of the last own row (inner index)
    return a0, a1 - a0 + 1, _cdiv(W - 2, ot)


@functools.lru_cache(maxsize=256)
def shard_rb_plan(R: int, W: int, h: int, kb: int, *, ot: Optional[int] = None
                  ) -> ShardPlan:
    """The fused form's plan for an (R, W) block with an h-row halo and kb
    sweeps (see the module docstring). `ot` overrides the tile side (the
    card gates hold both sides at every kb)."""
    rows = R - 2 * h
    if kb < 1 or h < 1 or rows < 1 or W < 3:
        raise ValueError(f"no fused plan for a ({R}, {W}) block with h={h}, kb={kb}")
    if ot is None:
        a0, ty, tx = _tiles(R, W, h, 64)
        ot = 64 if smem_bytes(64, kb) <= SMEM_BUDGET and ty * tx >= MIN_BLOCKS else 32
    if ot not in (32, 64):
        raise ValueError(f"the output tile is 32 or 64 cells, got {ot}")
    smem = smem_bytes(ot, kb)
    if smem > SMEM_BUDGET:
        raise ValueError(
            f"kb={kb} sweeps need {smem} bytes of shared memory a block "
            f"(a {ot}-cell tile with a {2 * kb}-cell halo), past the fused "
            f"kernel's budget of {SMEM_BUDGET}")
    a0, ty, tx = _tiles(R, W, h, ot)
    m = ot // SUM_TILE
    gx, gy = _cdiv(W - 2, SUM_TILE), _cdiv(R - 2, SUM_TILE)  # n_partials
    return ShardPlan(ot, kb, tx, a0, ty, smem, gx, gy,
                     a0 * m * gx, min((a0 + ty) * m, gy) * gx)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Params(ctypes.Structure):
    """csrc/shard_rb.cu's ShardRbParams, field for field."""

    _fields_ = [("partials", _P), ("ticket", _P), ("state", _P),
                *((n, _I) for n in ("R", "W", "nxg", "h", "rows", "kb", "ot", "tiles_x",
                                    "a0", "tiles_y", "smem", "gx_sum", "n_sum", "z0",
                                    "z1", "mode")),
                *((n, _F) for n in ("inv_dx2", "inv_dy2", "volp", "sor", "inv_ap",
                                    "ap_d", "tol", "n_cells", "reset_ratio", "ratio")),
                *((n, _I) for n in ("max_iter", "patience", "min_checks", "pad"))]


def make_params(plan: ShardPlan, R: int, W: int, *, nxg: int, h: int, mode: int,
                inv_dx2: float, inv_dy2: float, volp: float, sor: float = 0.0,
                inv_ap: float = 0.0, ap_d: float = 0.0, partials: int, ticket: int,
                state: int = 0, tol: float = 0.0, n_cells: float = 0.0,
                stall=(0.0, 0.0, 0, 0), max_iter: int = 0) -> Params:
    """The parameter block of one call site; pointers as ints (0: none).
    `stall` is (reset_ratio, ratio, patience, min_checks). The caller keeps
    the tensors behind the pointers alive as long as the block."""
    return Params(partials, ticket, state or None,
                  R, W, nxg, h, R - 2 * h, plan.kb, plan.ot, plan.tiles_x, plan.a0,
                  plan.tiles_y, plan.smem, plan.gx_sum, plan.n_sum, plan.z0, plan.z1, mode, inv_dx2, inv_dy2, volp, sor, inv_ap, ap_d,
                  float(np.float32(tol)), n_cells, stall[0], stall[1], max_iter,
                  stall[2], stall[3], 0)
