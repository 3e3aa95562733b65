"""Ghost-cell boundary-condition fills (counterpart of `sr_for_cfd_tpu/ops/bc.py`).

* Dirichlet: ghost = 2 * value - interior (value held at the face)
* Neumann (zero-gradient): ghost = interior
* Only the non-corner ghost entries are written (j in [1, ny] for
  left/right, i in [1, nx] for top/bottom); corners keep their values.

Fields are padded (nx+2, ny+2) tensors with x on axis 0. Every function
returns a new tensor and leaves its input untouched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import DIRICHLET, BFSGeometry, MeshParameters, VariableBCs
from ..utils.device import resolve_device


def _ghost(bc_side, interior: torch.Tensor) -> torch.Tensor:
    if bc_side.type == DIRICHLET:
        return 2.0 * bc_side.value - interior
    return interior


def apply_bc(a: torch.Tensor, bc: VariableBCs) -> torch.Tensor:
    """Fill the ghost ring of a padded (nx+2, ny+2) field per `bc`."""
    a = a.clone()
    a[0, 1:-1] = _ghost(bc.left, a[1, 1:-1])
    a[-1, 1:-1] = _ghost(bc.right, a[-2, 1:-1])
    a[1:-1, -1] = _ghost(bc.top, a[1:-1, -2])
    a[1:-1, 0] = _ghost(bc.bottom, a[1:-1, 1])
    return a


class BFSInletProfile(NamedTuple):
    """Left-boundary inlet data, indexed by the padded j: `below` marks
    cell centres under the step, `u_in` is the parabolic inlet profile."""

    below: torch.Tensor
    u_in: torch.Tensor


def bfs_inlet_profile(
    mesh: MeshParameters, geom: BFSGeometry, dtype=torch.float32,
    device="cuda",
) -> BFSInletProfile:
    device = resolve_device(device)
    yc = (np.arange(0, mesh.ny + 2) - 0.5) * mesh.dy
    below = yc < geom.step_height
    yprime = np.clip(yc - geom.step_height, 0.0, geom.h)
    u_in = 6.0 * geom.Ub * (yprime / geom.h) * (1.0 - yprime / geom.h)
    return BFSInletProfile(
        below=torch.as_tensor(below, device=device),
        u_in=torch.as_tensor(u_in, dtype=dtype, device=device),
    )


def apply_bfs_inlet(
    a: torch.Tensor, k: int, profile: Optional[BFSInletProfile]
) -> torch.Tensor:
    """Override the left ghost column with the BFS wall/inlet mixture:
    k = 0 (u): -interior below the step, 2 u_in - interior above;
    k = 1 (v): -interior everywhere; k = 2 (p): untouched."""
    if profile is None or k not in (0, 1):
        return a
    a = a.clone()
    inner = a[1, 1:-1]
    if k == 1:
        ghost = -inner
    else:
        ghost = torch.where(profile.below[1:-1], -inner,
                            2.0 * profile.u_in[1:-1] - inner)
    a[0, 1:-1] = ghost
    return a
