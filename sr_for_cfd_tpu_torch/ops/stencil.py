"""Finite-volume stencils, plain PyTorch (counterpart of `sr_for_cfd_tpu/ops/stencil.py`).

Array conventions are the JAX package's:
  * a padded field has shape (nx+2, ny+2); axis 0 is x (i), axis 1 is y (j)
  * face fluxes are interior-shaped (nx, ny) tensors (fe, fn, fw, fs)
  * QUICK's +-2 neighbours are clamped to the ghost ring (edge padding)

Each expression keeps the JAX package's operation order, so float64 runs
agree to rounding. The convection terms come as a flux and a diagonal
(`*_flux`, `*_diag`: the JAX package's `*_convection` pair), because the
diagonal depends only on the fluxes, which an inner solve freezes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class Shifted(NamedTuple):
    """Interior-shaped shifted views of a padded (nx+2, ny+2) field."""

    c: torch.Tensor
    e: torch.Tensor
    w: torch.Tensor
    n: torch.Tensor
    s: torch.Tensor
    ee: torch.Tensor
    ww: torch.Tensor
    nn: torch.Tensor
    ss: torch.Tensor


def shifts1(a: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(center, east, west, north, south) interior views; no copies."""
    return a[1:-1, 1:-1], a[2:, 1:-1], a[:-2, 1:-1], a[1:-1, 2:], a[1:-1, :-2]


def shifts2(a: torch.Tensor) -> Shifted:
    """All +-1 and +-2 shifted interior views, +-2 clamped to the ghosts."""
    a2 = F.pad(a[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return Shifted(
        c=a2[2:-2, 2:-2], e=a2[3:-1, 2:-2], w=a2[1:-3, 2:-2],
        n=a2[2:-2, 3:-1], s=a2[2:-2, 1:-3], ee=a2[4:, 2:-2],
        ww=a2[:-4, 2:-2], nn=a2[2:-2, 4:], ss=a2[2:-2, :-4],
    )


class FaceFluxes(NamedTuple):
    """Signed mass fluxes through the four faces of every interior cell
    (west/south carry a negative sign)."""

    e: torch.Tensor
    n: torch.Tensor
    w: torch.Tensor
    s: torch.Tensor

    def divergence_sum(self) -> torch.Tensor:
        return self.e + self.n + self.w + self.s


def face_fluxes(u: torch.Tensor, v: torch.Tensor, dx: float, dy: float) -> FaceFluxes:
    """Linear face interpolation of cell velocities times face length."""
    uc, ue, uw, _, _ = shifts1(u)
    vc, _, _, vn, vs = shifts1(v)
    return FaceFluxes(
        e=(uc + ue) * (0.5 * dy),
        n=(vc + vn) * (0.5 * dx),
        w=-(uc + uw) * (0.5 * dy),
        s=-(vc + vs) * (0.5 * dx),
    )


def flux_signs(ff: FaceFluxes) -> Tuple[torch.Tensor, ...]:
    """(ff.e >= 0, ff.n >= 0, ff.w >= 0, ff.s >= 0): the upwind side of
    every face, fixed while the fluxes are frozen."""
    return tuple(f >= 0 for f in ff)


def upwind_flux(phi: torch.Tensor, ff: FaceFluxes, signs=None,
                shifts=None) -> torch.Tensor:
    """First-order upwind convective flux Fc (face value = donor cell).
    `shifts` optionally supplies pre-built (c, e, w, n, s) views (the
    row-decomposed solver builds them from halo-extended bands,
    `parallel/spmd_step.py`)."""
    c, e, w, n, s = shifts1(phi) if shifts is None else shifts
    pe, pn, pw, ps = flux_signs(ff) if signs is None else signs
    return (torch.where(pe, c, e) * ff.e + torch.where(pw, c, w) * ff.w
            + torch.where(pn, c, n) * ff.n + torch.where(ps, c, s) * ff.s)


def upwind_diag(ff: FaceFluxes, volp: float, signs=None) -> torch.Tensor:
    """Upwind diagonal ap_c: only outflow faces (F >= 0) contribute."""
    pe, pn, pw, ps = flux_signs(ff) if signs is None else signs
    zero = torch.zeros((), dtype=ff.e.dtype, device=ff.e.device)
    sum_flux = (torch.where(pe, ff.e, zero) + torch.where(pw, ff.w, zero)
                + torch.where(pn, ff.n, zero) + torch.where(ps, ff.s, zero))
    return sum_flux * volp


def quick_flux(phi: torch.Tensor, ff: FaceFluxes, signs=None,
               shifts: "Shifted" = None) -> torch.Tensor:
    """QUICK convective flux Fc (weights 0.75 / 0.375 / -0.125); `shifts`
    optionally supplies a pre-built `Shifted`."""
    v = shifts2(phi) if shifts is None else shifts
    pe, pn, pw, ps = flux_signs(ff) if signs is None else signs
    ue = torch.where(pe, 0.75 * v.c + 0.375 * v.e - 0.125 * v.w,
                     0.75 * v.e + 0.375 * v.c - 0.125 * v.ee)
    uw = torch.where(pw, 0.75 * v.c + 0.375 * v.w - 0.125 * v.e,
                     0.75 * v.w + 0.375 * v.c - 0.125 * v.ww)
    un = torch.where(pn, 0.75 * v.c + 0.375 * v.n - 0.125 * v.s,
                     0.75 * v.n + 0.375 * v.c - 0.125 * v.nn)
    us = torch.where(ps, 0.75 * v.c + 0.375 * v.s - 0.125 * v.n,
                     0.75 * v.s + 0.375 * v.c - 0.125 * v.ss)
    return ue * ff.e + uw * ff.w + un * ff.n + us * ff.s


def quick_diag(ff: FaceFluxes, volp: float, signs=None) -> torch.Tensor:
    """QUICK diagonal ap_c: 0.75 on upwind faces, 0.375 on downwind."""
    signs = flux_signs(ff) if signs is None else signs

    def wt(pos):
        return torch.where(pos, 0.75, 0.375).to(ff.e.dtype)

    pe, pn, pw, ps = signs
    sum_flux = (wt(pe) * ff.e + wt(pw) * ff.w + wt(pn) * ff.n
                + wt(ps) * ff.s)
    return sum_flux * volp


def diffusion(
    phi: torch.Tensor, dx: float, dy: float, volp: float, shifts=None
) -> Tuple[torch.Tensor, float]:
    """5-point Laplacian flux Fd and (scalar) diagonal ap_d; `shifts`
    optionally supplies pre-built (c, e, w, n, s) views."""
    c, e, w, n, s = shifts1(phi) if shifts is None else shifts
    fd = volp * ((e - 2.0 * c + w) / (dx * dx) + (n - 2.0 * c + s) / (dy * dy))
    ap_d = -volp * (2.0 / (dx * dx) + 2.0 / (dy * dy))
    return fd, ap_d


def rhie_chow_update(
    ff: FaceFluxes, p: torch.Tensor, dt: float, rho: float, dx: float, dy: float
) -> FaceFluxes:
    """Post-pressure face-flux correction Ff += -dt/rho dp/dn face/delta."""
    pc, pe, pw, pn, ps = shifts1(p)
    c = dt / rho
    return FaceFluxes(
        e=ff.e - c * (pe - pc) * dy / dx,
        n=ff.n - c * (pn - pc) * dx / dy,
        w=ff.w - c * (pw - pc) * dy / dx,
        s=ff.s - c * (ps - pc) * dx / dy,
    )


def project_velocity(
    u: torch.Tensor, v: torch.Tensor, p: torch.Tensor, dt: float, rho: float,
    dx: float, dy: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Velocity projection u -= dt/rho dp/dx (central), v likewise;
    interior only, ghosts untouched."""
    pc, pe, pw, pn, ps = shifts1(p)
    du = -(dt / rho) * (pe - pw) / (2.0 * dx)
    dv = -(dt / rho) * (pn - ps) / (2.0 * dy)
    u = u.clone()
    v = v.clone()
    u[1:-1, 1:-1] += du
    v[1:-1, 1:-1] += dv
    return u, v


def residual_sumsq(new: torch.Tensor, old_interior: torch.Tensor) -> torch.Tensor:
    """Sum over the interior of (new - old)^2."""
    d = new[1:-1, 1:-1] - old_interior
    return torch.sum(d * d)


def under_relax(
    phi: torch.Tensor, old_interior: torch.Tensor, alpha: float
) -> torch.Tensor:
    """Interior under-relaxation Var = Old + alpha (Var - Old); alpha == 1
    is the identity."""
    if alpha == 1.0:
        return phi
    out = phi.clone()
    out[1:-1, 1:-1] = old_interior + alpha * (phi[1:-1, 1:-1] - old_interior)
    return out
