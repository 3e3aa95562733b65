"""Solver state (counterpart of `sr_for_cfd_tpu/solver/state.py`).

`u, v, p` are padded (nx+2, ny+2) tensors, the `*_old` copies interior
(nx, ny) tensors and the face fluxes interior-shaped. The JAX package keeps
every scalar of the outer loop on the device, because its loop runs there;
here the host runs the outer loop and reads the residuals every step, so
the scalar carries (rms, counters, detector windows) are host values: numpy
scalars and arrays of the working dtype, whose arithmetic rounds as the
device's does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..config import CaseConfig
from ..ops.bc import BFSInletProfile, apply_bc, apply_bfs_inlet, bfs_inlet_profile
from ..ops.stencil import FaceFluxes, face_fluxes
from ..utils.device import resolve_device

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class SolverState:
    u: torch.Tensor  # (nx+2, ny+2)
    v: torch.Tensor
    p: torch.Tensor
    u_old: torch.Tensor  # (nx, ny) interior
    v_old: torch.Tensor
    p_old: torch.Tensor
    ff: FaceFluxes  # interior (nx, ny) x 4
    rms: np.ndarray  # (3,) residual RMS of the last step
    count: int = 0  # outer iterations completed
    converged: bool = False
    diverged: bool = False
    # detector carries (see SolverSettings): sustained hold, plateau
    # window, Cauchy reference fields
    held: int = 0
    plat_best: Optional[np.ndarray] = None
    plat_acc: Optional[np.ndarray] = None
    plat_n: int = 0
    plat_stale: int = 0
    cau_u_ref: Optional[torch.Tensor] = None
    cau_v_ref: Optional[torch.Tensor] = None
    cau_count: int = 0

    def replace(self, **kw) -> "SolverState":
        return dataclasses.replace(self, **kw)

    def var(self) -> np.ndarray:
        """The reference's Var[3, nx+2, ny+2] layout, on the host."""
        return np.stack([t.detach().cpu().numpy() for t in (self.u, self.v, self.p)])

    def interior_fields(self) -> Dict[str, np.ndarray]:
        """{u, v, p} interior transposed to (ny, nx)."""
        return {k: getattr(self, k)[1:-1, 1:-1].T.detach().cpu().numpy().copy()
                for k in ("u", "v", "p")}


def torch_dtype(case: CaseConfig) -> torch.dtype:
    return DTYPES[case.settings.dtype]


def np_dtype(case: CaseConfig):
    return np.dtype(case.settings.dtype)


def inlet_profile(case: CaseConfig, device="cuda") -> Optional[BFSInletProfile]:
    if case.bfs is None:
        return None
    return bfs_inlet_profile(case.mesh, case.bfs, dtype=torch_dtype(case),
                             device=device)


def _finalize(u, v, p, case: CaseConfig, profile) -> SolverState:
    """Apply BCs, seed the old copies and the face fluxes."""
    u = apply_bfs_inlet(apply_bc(u, case.u_bc), 0, profile)
    v = apply_bfs_inlet(apply_bc(v, case.v_bc), 1, profile)
    p = apply_bc(p, case.p_bc)
    ff = face_fluxes(u, v, case.mesh.dx, case.mesh.dy)
    dt = np_dtype(case)
    return SolverState(
        u=u, v=v, p=p,
        u_old=u[1:-1, 1:-1], v_old=v[1:-1, 1:-1], p_old=p[1:-1, 1:-1],
        ff=ff,
        rms=np.full((3,), np.inf, dtype=dt),
        plat_best=np.full((3,), np.inf, dtype=dt),
        plat_acc=np.zeros((3,), dtype=dt),
        cau_u_ref=u, cau_v_ref=v,
    )


def init_state(case: CaseConfig, device="cuda") -> SolverState:
    """Zero-initialised state with BCs applied."""
    device = resolve_device(device)
    shape = (case.mesh.nx + 2, case.mesh.ny + 2)
    z = torch.zeros(shape, dtype=torch_dtype(case), device=device)
    return _finalize(z, z, z, case, inlet_profile(case, device))


def warm_start_state(case: CaseConfig, fields: Dict[str, np.ndarray],
                     device="cuda") -> SolverState:
    """State from (ny, nx)-shaped interior fields (the ML injection path):
    re-seeds ghosts, old copies and face fluxes."""
    device = resolve_device(device)
    nx, ny = case.mesh.nx, case.mesh.ny
    dt = torch_dtype(case)

    def embed(f):
        f = torch.as_tensor(np.asarray(f), device=device).to(dt)
        if tuple(f.shape) != (ny, nx):
            raise ValueError(f"expected ({ny}, {nx}) field, got {tuple(f.shape)}")
        out = torch.zeros((nx + 2, ny + 2), dtype=dt, device=device)
        out[1:-1, 1:-1] = f.T
        return out

    return _finalize(embed(fields["u"]), embed(fields["v"]),
                     embed(fields["p"]), case, inlet_profile(case, device))
