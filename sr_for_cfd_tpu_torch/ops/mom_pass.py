"""Host side of the fused momentum pass (`csrc/mom_pass.cu`).

The fused pass runs k whole red-black momentum sweeps and the last sweep's
residual sum in one launch, from shared memory. The big-grid momentum loop
(row 4, `ops/momentum_kernels.py`, k = 3) and the fused step's momentum
loop (row 3, `ops/step_kernels.py` design (b), k = momentum_check_every)
launch it once per pass, with the loop's exit decided on the card
(`MomentumLoop`, on `ops/exit_loop.py`'s `DeviceExitLoop`).

`mom_plan(nx2, ny2, k, quick)`: output tiles of TILE x TILE cells of the
padded field anchored at padded (0, 0), so that each tile is whole 32 x 8
blocks of the staged half-sweep's grid and the partial sums keep that
form's index and thread order; one block a tile. A block loads its tile
with a halo of 2k + quick cells: 4 (7 L^2 + TILE^2) bytes with
L = TILE + 2 (2k + quick), at most SMEM_BUDGET. `fits(k, quick)` says
whether k sweeps have a plan (k <= 13 QUICK, <= 14 UPWIND); the wrappers
run a larger k on the staged half-sweeps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import kernel_lib
from .exit_loop import DeviceExitLoop
from .stencil import FaceFluxes
from .sweeps import STALL_MIN_CHECKS, STALL_PATIENCE, STALL_RATIO, STALL_RESET_RATIO

# csrc/mom_pass.cu: MOM_PASS_SMEM_BUDGET, MOM_SUMS and MOM_TILE;
# csrc/common.cuh: SRCFD_TX, SRCFD_TY
SMEM_BUDGET = 216 * 1024
MOM_SUMS = 8
TILE = 32
BLOCK_X, BLOCK_Y = 32, 8


class MomPlan(NamedTuple):
    ot: int  # output tile side: TILE
    k: int
    quick: int
    halo: int
    tiles_x: int
    tiles_y: int
    smem: int  # dynamic shared bytes a block
    gx: int  # the staged half-sweep's 32 x 8 grid over the padded field
    gy: int

    @property
    def n_part(self) -> int:
        """Partials of one colour (the staged form's per half-sweep)."""
        return self.gx * self.gy

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(k: int, quick: bool) -> int:
    side = TILE + 2 * (2 * k + int(quick))
    return 4 * (7 * side * side + TILE * TILE)


def fits(k: int, quick: bool) -> bool:
    """Whether k sweeps have a fused plan."""
    return k >= 1 and smem_bytes(k, quick) <= SMEM_BUDGET


@functools.lru_cache(maxsize=64)
def mom_plan(nx2: int, ny2: int, k: int, quick: bool) -> MomPlan:
    """The fused pass's plan for a padded (nx2, ny2) field and k sweeps (see
    the module docstring)."""
    if k < 1 or nx2 < 3 or ny2 < 3:
        raise ValueError(f"no fused momentum plan for a ({nx2}, {ny2}) field, k={k}")
    smem = smem_bytes(k, quick)
    if smem > SMEM_BUDGET:
        raise ValueError(
            f"k={k} momentum sweeps need {smem} bytes of shared memory a block "
            f"(a {TILE}-cell tile with a {2 * k + int(quick)}-cell halo), past the "
            f"fused pass's budget of {SMEM_BUDGET}")
    return MomPlan(TILE, k, int(quick), 2 * k + int(quick), _cdiv(ny2, TILE),
                   _cdiv(nx2, TILE), smem, _cdiv(ny2, BLOCK_X), _cdiv(nx2, BLOCK_Y))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Params(ctypes.Structure):
    """csrc/mom_pass.cu's MomPassParams, field for field."""

    _fields_ = [("partials", _P), ("ticket", _P), ("state", _P),
                *((n, _I) for n in ("nx2", "ny2", "quick", "k", "old_padded", "ot", "halo",
                                    "tiles_x", "tiles_y", "smem", "gx", "gy", "max_iter",
                                    "on_best", "patience", "min_checks")),
                *((n, _F) for n in ("volp", "volp_dt", "inv_dx2", "inv_dy2", "ap_d", "tol",
                                    "n_cells", "reset_ratio", "ratio")),
                ("pad", _I)]


class Coef(NamedTuple):
    """The momentum coefficients, as the staged form's parameter blocks
    take them (Python floats, rounded to float32 by ctypes)."""

    volp: float
    volp_dt: float
    inv_dx2: float
    inv_dy2: float
    ap_d: float


def make_params(plan: MomPlan, nx2: int, ny2: int, coef: Coef, *, old_padded: bool,
                partials: int, ticket: int, state: int = 0, tol: float = 0.0,
                max_iter: int = 0, on_best: bool = False) -> Params:
    """The parameter block of one loop; pointers as ints (0: none). The
    caller keeps the tensors behind the pointers alive as long as the
    block."""
    return Params(partials, ticket, state or None, nx2, ny2, plan.quick, plan.k,
                  int(old_padded), plan.ot, plan.halo, plan.tiles_x, plan.tiles_y,
                  plan.smem, plan.gx, plan.gy, int(max_iter), int(on_best),
                  STALL_PATIENCE, STALL_MIN_CHECKS, *coef, float(np.float32(tol)),
                  float((nx2 - 2) * (ny2 - 2)), STALL_RESET_RATIO, STALL_RATIO, 0)


def _args(old: torch.Tensor, ff: FaceFluxes, nu: torch.Tensor):
    return (old.data_ptr(), *(t.data_ptr() for t in ff), nu.data_ptr())


class MomentumLoop(DeviceExitLoop):
    """The device-exit momentum loop of one shape and setting: the pass's
    parameter block with the partials, ticket and loop state it points at,
    owned here. `solve` runs passes of k sweeps from f0 between two fresh
    buffers until the kernel sets `done`."""

    def __init__(self, nx2: int, ny2: int, device, *, quick: bool, k: int,
                 old_padded: bool, coef: Coef, tol: float, max_iter: int,
                 on_best: bool, batch: int, ahead: bool, counter):
        super().__init__(device, tol, max_iter, counter=counter, per_launch=k,
                         on_best=on_best, batch=batch, ahead=ahead)
        self.plan = mom_plan(nx2, ny2, k, quick)
        self.partials = torch.zeros(2 * self.plan.n_part, dtype=torch.float32,
                                    device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.params = make_params(self.plan, nx2, ny2, coef, old_padded=old_padded,
                                  partials=self.partials.data_ptr(),
                                  ticket=self.ticket.data_ptr(),
                                  state=self.state.data_ptr(), tol=tol,
                                  max_iter=self.max_iter, on_best=on_best)
        self.addr = ctypes.addressof(self.params)

    def solve(self, f0: torch.Tensor, old: torch.Tensor, ff: FaceFluxes,
              nu: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """Passes from f0 (its ghosts carried through); returns (the buffer
        the last pass wrote, or f0 itself when none ran; sweeps run)."""
        bufs = [torch.empty_like(f0), torch.empty_like(f0)]
        args = _args(old, ff, nu)

        def launch(i, stream):
            src = f0 if i == 0 else bufs[(i - 1) % 2]
            kernel_lib.check(self.lib.srcfd_mom_pass(
                self.addr, src.data_ptr(), bufs[i % 2].data_ptr(), *args, None, stream),
                "mom_pass")

        it = self.run(launch)
        passes = it // self.per_launch
        return (bufs[(passes - 1) % 2] if passes else f0), it


@functools.lru_cache(maxsize=8)
def cached_loop(nx2: int, ny2: int, device: str, quick: bool, k: int, old_padded: bool,
                coef: Coef, tol: float, max_iter: int, on_best: bool, batch: int,
                ahead: bool, counter) -> MomentumLoop:
    """The loop of one setting, built once: every solve with this setting
    reuses its parameter block and state."""
    return MomentumLoop(nx2, ny2, device, quick=quick, k=k, old_padded=old_padded,
                        coef=coef, tol=tol, max_iter=max_iter, on_best=on_best,
                        batch=batch, ahead=ahead, counter=counter)


class OnePass:
    """One fused pass with no loop state (the rms to a device scalar): what
    the card gates and timings launch alone, against the staged form."""

    def __init__(self, nx2: int, ny2: int, device, *, quick: bool, k: int,
                 old_padded: bool, coef: Coef):
        self.lib = kernel_lib.load_library()
        self.device = torch.device(device)
        self.plan = mom_plan(nx2, ny2, k, quick)
        self.partials = torch.zeros(2 * self.plan.n_part, dtype=torch.float32,
                                    device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.rms = torch.zeros(1, dtype=torch.float32, device=self.device)
        self.params = make_params(self.plan, nx2, ny2, coef, old_padded=old_padded,
                                  partials=self.partials.data_ptr(),
                                  ticket=self.ticket.data_ptr())

    def __call__(self, src: torch.Tensor, dst: torch.Tensor, old: torch.Tensor,
                 ff: FaceFluxes, nu: torch.Tensor) -> None:
        """k sweeps src -> dst; the rms to self.rms."""
        kernel_lib.check(self.lib.srcfd_mom_pass(
            ctypes.addressof(self.params), src.data_ptr(), dst.data_ptr(),
            *_args(old, ff, nu), self.rms.data_ptr(),
            kernel_lib.stream_ptr(self.device)), "mom_pass")


class StagedPass:
    """The staged form of one pass, what the card gates and tests hold the
    fused pass against: 2k launches of momentum.cuh's half-sweep kernel
    f -> g -> f (the last sweep's partials) and srcfd_rms_finalize, no host
    read. The big-grid loop's entry (tiled_momentum.cu, the old field
    interior-shaped) or, with `step_prm` (the fused step's StepParams), the
    fused step's (fused_step.cu, the old field padded)."""

    def __init__(self, f: torch.Tensor, old: torch.Tensor, ff: FaceFluxes,
                 nu: torch.Tensor, k: int, quick: bool, coef: Coef, step_prm=None):
        self.lib = kernel_lib.load_library()
        self.stream = kernel_lib.stream_ptr(f.device)
        nx2, ny2 = f.shape
        self.n = self.lib.srcfd_step_mom_partials(nx2, ny2)
        self.partials = torch.empty(2 * self.n, dtype=torch.float32, device=f.device)
        self.rms = torch.empty(1, dtype=torch.float32, device=f.device)
        self.g = torch.empty_like(f)
        self.k, self.cells = k, float((nx2 - 2) * (ny2 - 2))
        self.args = _args(old, ff, nu)
        self.step_prm = step_prm
        self.consts = (nx2, ny2, int(quick), *coef)

    def half(self, src: torch.Tensor, dst: torch.Tensor, color: int, partials) -> None:
        if self.step_prm is not None:
            code = self.lib.srcfd_step_mom_half(
                src.data_ptr(), dst.data_ptr(), *self.args,
                ctypes.addressof(self.step_prm), color, partials, self.stream)
        else:
            code = self.lib.srcfd_tm_half(src.data_ptr(), dst.data_ptr(), *self.args,
                                          *self.consts, color, partials, self.stream)
        kernel_lib.check(code, "staged momentum half-sweep")

    def __call__(self, f: torch.Tensor) -> None:
        """k sweeps of f in place; the rms to self.rms."""
        red = self.partials.data_ptr()
        black = red + 4 * self.n
        for s in range(self.k):
            last = s == self.k - 1
            self.half(f, self.g, 0, red if last else None)
            self.half(self.g, f, 1, black if last else None)
        kernel_lib.check(self.lib.srcfd_rms_finalize(
            red, 2 * self.n, self.cells, self.rms.data_ptr(), self.stream), "rms_finalize")
