"""Whole SIMPLE outer steps on the card (counterpart of `sr_for_cfd_tpu/ops/pallas_step.py`).

`simple_step_kernel` is the port of `pallas_simple_step`
(`sr_for_cfd_tpu/ops/pallas_step.py:414`, kernel body `make_step_kernel`
:82): `steps_per_kernel` whole outer iterations -- both momentum
red-black loops with the stall policy, under-relaxation, boundary fills
with the BFS inlet, face fluxes, the pressure solve (point iteration or
V-cycles), projection, residual sums and Rhie-Chow. It returns
(u, v, p, FaceFluxes, res_sums[3], counts[3]): the residual sums of the
last step and the inner counts (u sweeps, v sweeps, p sweeps or V-cycles)
summed over the steps. The CUDA source is `csrc/fused_step.cu`.

What bounds it on the H100, and the design. A step is a few dozen stencil
sweeps over a few fields, so it is bound by latency (launches, barriers,
host reads), not by bytes or arithmetic: ~1e5 float32 operations per step
on the 12x12 coarse grid, ~2 MB per sweep at 400x400, inside the L2.
* Design (a): where the 12 padded fields fit one block's shared memory
  (up to ~66x66 interior), one block runs all K steps with
  `__syncthreads()` only: one launch and one host read per K steps. This
  is the coarse phase (12x12, K=500).
* Design (b): one launch per stage (momentum half-sweeps, relaxation,
  boundary fills, fluxes, projection with residual sums and Rhie-Chow),
  with the inner loops' exits decided on the host from one fixed-order
  rms read per check, as the pressure wrappers do. The pressure stage is
  `ops/mg_kernels.py` (multigrid mode: the same frozen-ghost system as
  the TPU kernel's embedded V-cycle) or `ops/pressure_kernels.py` (point
  iteration, omega clamped as in the TPU kernel, and `rb_sor.cu` in its
  divide form, (sor r) / ap_d, as `pallas_step.py:309`). This is the
  400x400 fine phases, and any point-iteration grid too large for (a).
No design waits on another block; every loop is bounded by K, max_iter,
MG_MAX_CYCLES or a size.

`simple_step_plain` is the plain PyTorch version. It follows the TPU
kernel's arithmetic, not the non-fused step's (`solver/simple.py`):
Laplacians multiplied by 1/dx^2 and 1/dy^2, the diagonal
ap_d = -volp (2/dx^2 + 2/dy^2), the pressure update (sor r) / ap_d with
omega clamped to `optimal_sor`, QUICK's far neighbours clamped at the
first and last interior lines, the kernel's boundary fill order and the
multigrid mode's frozen-ghost right-hand side.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernels or raises. `simple_step_kernel.launches` counts the
launches of `fused_step.cu` kernels (the pressure stage of (b) counts on
its own wrappers).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DIRICHLET, QUICK, CaseConfig
from . import kernel_lib
from .bc import BFSInletProfile, apply_bc, apply_bfs_inlet
from .multigrid import MG_MAX_CYCLES, mg_solve_pressure
from .stencil import (
    FaceFluxes,
    face_fluxes,
    flux_signs,
    project_velocity,
    quick_diag,
    quick_flux,
    residual_sumsq,
    rhie_chow_update,
    shifts1,
    under_relax,
    upwind_diag,
    upwind_flux,
)
from .sweeps import (
    STALL_MIN_CHECKS,
    STALL_PATIENCE,
    STALL_RATIO,
    STALL_RESET_RATIO,
    optimal_sor,
    stall_update,
    stalled,
    sweep_loop,
)

StepResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, FaceFluxes,
                   torch.Tensor, List[int]]


def _laplacian(f, volp, inv_dx2, inv_dy2):
    """volp-scaled 5-point Laplacian of the interior, multiplied by the
    inverse squared spacings as the TPU kernel does."""
    c, e, w, n, s = shifts1(f)
    return volp * ((e - 2.0 * c + w) * inv_dx2 + (n - 2.0 * c + s) * inv_dy2)


def _coefficients(case: CaseConfig):
    mesh, st = case.mesh, case.settings
    inv_dx2 = 1.0 / (mesh.dx * mesh.dx)
    inv_dy2 = 1.0 / (mesh.dy * mesh.dy)
    ap_d = -mesh.volp * (2.0 * inv_dx2 + 2.0 * inv_dy2)
    sor = min(st.pressure_sor, optimal_sor(mesh.nx, mesh.ny))
    return inv_dx2, inv_dy2, ap_d, sor


def _plain_one_step(u0, v0, p0, ff, case: CaseConfig, profile, nu):
    mesh, fluid, st = case.mesh, case.fluid, case.settings
    nx, ny = mesh.nx, mesh.ny
    dx, dy, volp, dt, rho = mesh.dx, mesh.dy, mesh.volp, st.dt, fluid.rho
    inv_dx2, inv_dy2, ap_d, sor = _coefficients(case)
    quick = st.scheme == QUICK
    signs = flux_signs(ff)
    ap = volp / dt + (quick_diag if quick else upwind_diag)(ff, volp, signs) - nu * ap_d
    flux = quick_flux if quick else upwind_flux
    loop = dict(nx=nx, ny=ny, tol=st.inner_tolerance, max_iter=st.inner_max_iter)

    def momentum(f0):
        f0_int = f0[1:-1, 1:-1]

        def residual(f):
            fd = _laplacian(f, volp, inv_dx2, inv_dy2)
            return -(volp / dt * (f[1:-1, 1:-1] - f0_int) + flux(f, ff, signs)
                     - nu * fd), ap

        return sweep_loop(f0, residual, check_every=max(1, st.momentum_check_every),
                          **loop)

    u, u_it = momentum(u0)
    u = under_relax(u, u0[1:-1, 1:-1], st.relax("u"))
    u = apply_bfs_inlet(apply_bc(u, case.u_bc), 0, profile)
    v, v_it = momentum(v0)
    v = under_relax(v, v0[1:-1, 1:-1], st.relax("v"))
    v = apply_bfs_inlet(apply_bc(v, case.v_bc), 1, profile)

    ff = face_fluxes(u, v, dx, dy)
    if st.pressure_solver == "multigrid":
        p, p_it = mg_solve_pressure(
            p0, ff, dx=dx, dy=dy, dt=dt, rho=rho, volp=volp,
            tol=st.inner_tolerance, max_cycles=MG_MAX_CYCLES,
            n_pre=st.mg_n_pre, n_post=st.mg_n_post,
            smoother_sor=st.mg_smoother_sor, min_size=st.mg_min_size,
            coarsest_sweeps=st.mg_coarsest_sweeps)
    else:
        b = (rho / dt) * ff.divergence_sum()
        # a tensor on the field's device: PyTorch's CUDA division by a
        # Python scalar multiplies by its reciprocal, by a tensor it divides
        ap_d_t = torch.tensor(ap_d, dtype=p0.dtype, device=p0.device)

        def residual(f):
            return b - _laplacian(f, volp, inv_dx2, inv_dy2), ap_d_t

        p, p_it = sweep_loop(p0, residual, check_every=max(1, st.pressure_check_every),
                             sor=sor, **loop)
    p = under_relax(p, p0[1:-1, 1:-1], st.relax("p"))
    p = apply_bc(p, case.p_bc)

    # the spacings as tensors on the fields' device, so that the card
    # divides by them as the kernel does
    dx_t, dy_t = (torch.tensor(h, dtype=u.dtype, device=u.device) for h in (dx, dy))
    u, v = project_velocity(u, v, p, dt, rho, dx_t, dy_t)
    res = torch.stack([residual_sumsq(u, u0[1:-1, 1:-1]),
                       residual_sumsq(v, v0[1:-1, 1:-1]),
                       residual_sumsq(p, p0[1:-1, 1:-1])])
    u = apply_bfs_inlet(apply_bc(u, case.u_bc), 0, profile)
    v = apply_bfs_inlet(apply_bc(v, case.v_bc), 1, profile)
    ff = rhie_chow_update(ff, p, dt, rho, dx_t, dy_t)
    return u, v, p, ff, res, (u_it, v_it, p_it)


def _nu_tensor(nu, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(nu, dtype=like.dtype, device=like.device).reshape(())


def simple_step_plain(u, v, p, ff: FaceFluxes, case: CaseConfig,
                      profile: Optional[BFSInletProfile], nu=None) -> StepResult:
    """`steps_per_kernel` outer steps in plain PyTorch, with the TPU
    kernel's arithmetic (see the module docstring)."""
    nu = _nu_tensor(case.fluid.nu if nu is None else nu, u)
    counts = [0, 0, 0]
    res = None
    for _ in range(max(1, case.settings.steps_per_kernel)):
        u, v, p, ff, res, cnt = _plain_one_step(u, v, p, ff, case, profile, nu)
        counts = [a + b for a, b in zip(counts, cnt)]
    return u, v, p, ff, res, counts


# ---- the kernels ---------------------------------------------------------


class StepParams(ctypes.Structure):
    """The C struct `StepParams` of `csrc/fused_step.cu`, field by field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "nx2", "ny2", "quick", "k_steps", "max_iter", "m_check", "p_check",
        "stall_patience", "stall_min_checks")] + [
        (name, ctypes.c_float) for name in (
            "stall_reset_ratio", "stall_ratio", "tol", "volp", "volp_dt",
            "inv_dx2", "inv_dy2", "ap_d", "sor", "alpha_u", "alpha_v",
            "alpha_p", "half_dx", "half_dy", "rho_dt", "c_dt_rho", "two_dx",
            "two_dy", "dx", "dy")] + [
        ("bc_type", ctypes.c_int * 12), ("bc_twice", ctypes.c_float * 12),
        ("bfs", ctypes.c_int)]


def step_params(case: CaseConfig, has_bfs: bool) -> StepParams:
    mesh, fluid, st = case.mesh, case.fluid, case.settings
    inv_dx2, inv_dy2, ap_d, sor = _coefficients(case)
    prm = StepParams(
        nx2=mesh.nx + 2, ny2=mesh.ny + 2, quick=int(st.scheme == QUICK),
        k_steps=max(1, st.steps_per_kernel), max_iter=st.inner_max_iter,
        m_check=max(1, st.momentum_check_every),
        p_check=max(1, st.pressure_check_every),
        stall_patience=STALL_PATIENCE, stall_min_checks=STALL_MIN_CHECKS,
        stall_reset_ratio=STALL_RESET_RATIO, stall_ratio=STALL_RATIO,
        tol=float(np.float32(st.inner_tolerance)), volp=mesh.volp,
        volp_dt=mesh.volp / st.dt, inv_dx2=inv_dx2, inv_dy2=inv_dy2,
        ap_d=ap_d, sor=sor, alpha_u=st.relax("u"), alpha_v=st.relax("v"),
        alpha_p=st.relax("p"), half_dx=0.5 * mesh.dx, half_dy=0.5 * mesh.dy,
        rho_dt=fluid.rho / st.dt, c_dt_rho=st.dt / fluid.rho,
        two_dx=2.0 * mesh.dx, two_dy=2.0 * mesh.dy, dx=mesh.dx, dy=mesh.dy,
        bfs=int(has_bfs))
    for var, spec in enumerate((case.u_bc, case.v_bc, case.p_bc)):
        for side, name in enumerate(("left", "right", "top", "bottom")):
            bc = getattr(spec, name)
            prm.bc_type[var * 4 + side] = 0 if bc.type == DIRICHLET else 1
            prm.bc_twice[var * 4 + side] = 2.0 * bc.value
    return prm


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _launch(code: int, what: str) -> None:
    kernel_lib.check(code, what)
    simple_step_kernel.launches += 1


def _inlet(profile: Optional[BFSInletProfile], like: torch.Tensor):
    """(u_in, below) as float32 device arrays of length ny+2."""
    if profile is None:
        z = torch.zeros(like.shape[1], dtype=torch.float32, device=like.device)
        return z, z
    return (profile.u_in.to(device=like.device, dtype=torch.float32).contiguous(),
            profile.below.to(device=like.device, dtype=torch.float32).contiguous())


def _small(lib, u, v, p, ff, prm, u_in, below, nu, stream) -> StepResult:
    """Design (a): one launch for all K steps."""
    outs = [torch.empty_like(t) for t in (u, v, p)]
    fouts = [torch.empty_like(t) for t in ff]
    res = torch.empty(3, dtype=torch.float32, device=u.device)
    counts = torch.empty(3, dtype=torch.int32, device=u.device)
    _launch(lib.srcfd_step_small(
        *map(_ptr, (u, v, p, *ff, u_in, below, nu)), ctypes.addressof(prm),
        *map(_ptr, (*outs, *fouts, res, counts)), stream), "step_small")
    return (*outs, FaceFluxes(*fouts), res, [int(x) for x in counts.tolist()])


class _Staged:
    """Design (b): device buffers and stage launches of one call."""

    def __init__(self, lib, case: CaseConfig, prm, u_in, below, nu, like):
        self.lib, self.case, self.prm = lib, case, prm
        self.u_in, self.below, self.nu = u_in, below, nu
        self.stream = kernel_lib.stream_ptr(like.device)
        nx2, ny2 = like.shape
        dev = like.device
        self.n_mom = lib.srcfd_step_mom_partials(nx2, ny2)
        self.n_proj = lib.srcfd_step_proj_partials(nx2, ny2)
        self.mom_part = torch.empty(2 * self.n_mom, dtype=torch.float32, device=dev)
        self.proj_part = torch.empty(3 * self.n_proj, dtype=torch.float32, device=dev)
        self.rms_dev = torch.empty(1, dtype=torch.float32, device=dev)
        self.n_cells = float((nx2 - 2) * (ny2 - 2))

    def momentum(self, f0: torch.Tensor, ff: FaceFluxes) -> Tuple[torch.Tensor, int]:
        """The red-black momentum loop, exits decided on the host."""
        st = self.case.settings
        prm = ctypes.addressof(self.prm)
        f, g = f0.clone(), torch.empty_like(f0)
        red = _ptr(self.mom_part)
        black = red + self.n_mom * self.mom_part.element_size()
        fl = [_ptr(t) for t in ff]
        m_check = max(1, st.momentum_check_every)
        t = np.float32
        rms = best = t(np.inf)
        tol32 = t(st.inner_tolerance)
        stale = checks = it = 0
        while it < st.inner_max_iter and best >= tol32 and not stalled(stale, checks):
            for s in range(m_check):
                last = s == m_check - 1
                _launch(self.lib.srcfd_step_mom_half(
                    _ptr(f), _ptr(g), _ptr(f0), *fl, _ptr(self.nu), prm, 0,
                    red if last else None, self.stream), "step_mom_half")
                _launch(self.lib.srcfd_step_mom_half(
                    _ptr(g), _ptr(f), _ptr(f0), *fl, _ptr(self.nu), prm, 1,
                    black if last else None, self.stream), "step_mom_half")
            _launch(self.lib.srcfd_rms_finalize(
                red, 2 * self.n_mom, self.n_cells, _ptr(self.rms_dev),
                self.stream), "rms_finalize")
            now = t(self.rms_dev.item())
            stale, best = stall_update(now, rms, best, stale)
            rms = now
            checks += 1
            it += m_check
        return f, it

    def bc(self, f, var: int) -> None:
        _launch(self.lib.srcfd_step_bc(_ptr(f), var, _ptr(self.u_in),
                                       _ptr(self.below), ctypes.addressof(self.prm),
                                       self.stream), "step_bc")

    def relax_bc(self, f, f0, alpha: float, var: int) -> None:
        nx2, ny2 = f.shape
        if alpha != 1.0:
            _launch(self.lib.srcfd_step_relax(_ptr(f), _ptr(f0), nx2, ny2, alpha,
                                              self.stream), "step_relax")
        self.bc(f, var)

    def pressure(self, p0, ff: FaceFluxes) -> Tuple[torch.Tensor, int]:
        mesh, fluid, st = self.case.mesh, self.case.fluid, self.case.settings
        kw = dict(dx=mesh.dx, dy=mesh.dy, dt=st.dt, rho=fluid.rho,
                  volp=mesh.volp, tol=st.inner_tolerance)
        if st.pressure_solver == "multigrid":
            from .mg_kernels import mg_solve_pressure_kernel

            return mg_solve_pressure_kernel(
                p0, ff, **kw, max_cycles=MG_MAX_CYCLES, n_pre=st.mg_n_pre,
                n_post=st.mg_n_post, smoother_sor=st.mg_smoother_sor,
                min_size=st.mg_min_size, coarsest_sweeps=st.mg_coarsest_sweeps)
        from .pressure_kernels import solve_pressure_kernel

        # the wrapper clamps omega to optimal_sor, as the TPU kernel does,
        # and divides by ap_d as pallas_step.py:309 does
        return solve_pressure_kernel(
            p0, ff, **kw, max_iter=st.inner_max_iter,
            check_every=max(1, st.pressure_check_every), sor=st.pressure_sor,
            divide=True)

    def step(self, u0, v0, p0, ff: FaceFluxes):
        st = self.case.settings
        prm = ctypes.addressof(self.prm)
        u, u_it = self.momentum(u0, ff)
        self.relax_bc(u, u0, st.relax("u"), 0)
        v, v_it = self.momentum(v0, ff)
        self.relax_bc(v, v0, st.relax("v"), 1)
        ff = FaceFluxes(*(torch.empty_like(t) for t in ff))
        _launch(self.lib.srcfd_step_fluxes(_ptr(u), _ptr(v), *map(_ptr, ff), prm,
                                           self.stream), "step_fluxes")
        p, p_it = self.pressure(p0, ff)
        self.relax_bc(p, p0, st.relax("p"), 2)
        _launch(self.lib.srcfd_step_project(
            _ptr(u), _ptr(v), _ptr(p), _ptr(u0), _ptr(v0), _ptr(p0),
            *map(_ptr, ff), _ptr(self.proj_part), prm, self.stream), "step_project")
        res = torch.empty(3, dtype=torch.float32, device=u.device)
        _launch(self.lib.srcfd_step_sums(_ptr(self.proj_part), self.n_proj,
                                         _ptr(res), self.stream), "step_sums")
        self.bc(u, 0)
        self.bc(v, 1)
        return u, v, p, ff, res, (u_it, v_it, p_it)


def simple_step_kernel(u, v, p, ff: FaceFluxes, case: CaseConfig,
                       profile: Optional[BFSInletProfile], nu=None,
                       _design: Optional[str] = None) -> StepResult:
    """`steps_per_kernel` whole outer steps; returns (u, v, p, ff,
    res_sums[3], counts[3]). `_design` ('a' or 'b', else
    `simple_step_kernel.force_design`) forces a design; by default (a)
    takes point-iteration grids that fit one block's shared memory and (b)
    the rest."""
    if u.device.type == "cpu":
        return simple_step_plain(u, v, p, ff, case, profile, nu=nu)
    for name, t in (("u", u), ("v", v), ("p", p)):
        kernel_lib.check_field(t, f"fused-step ({name})")
    ff = FaceFluxes(*(t.contiguous() for t in ff))
    for t in ff:
        if t.dtype != torch.float32 or t.device != u.device:
            raise ValueError("the fused-step kernel takes float32 face fluxes "
                             "on the fields' device")
    lib = kernel_lib.load_library()
    nx2, ny2 = u.shape
    small = (case.settings.pressure_solver != "multigrid"
             and lib.srcfd_step_small_fits(nx2, ny2))
    design = _design or simple_step_kernel.force_design or ("a" if small else "b")
    if design == "a" and not small:
        raise ValueError("design (a) runs the point-iteration pressure mode on "
                         "grids that fit one block's shared memory")
    prm = step_params(case, profile is not None)
    nu = _nu_tensor(case.fluid.nu if nu is None else nu, u).to(torch.float32)
    nu = nu.reshape(1).contiguous()
    u_in, below = _inlet(profile, u)
    if design == "a":
        return _small(lib, u, v, p, ff, prm, u_in, below, nu,
                      kernel_lib.stream_ptr(u.device))
    if design != "b":
        raise ValueError(f"unknown design {design!r}")
    staged = _Staged(lib, case, prm, u_in, below, nu, u)
    counts = [0, 0, 0]
    res = None
    for _ in range(prm.k_steps):
        u, v, p, ff, res, cnt = staged.step(u, v, p, ff)
        counts = [a + b for a, b in zip(counts, cnt)]
    return u, v, p, ff, res, counts


simple_step_kernel.launches = 0
# 'b' makes every call through the solver take design (b): the tests and
# chip_smoke.py drive (b) at small sizes with it
simple_step_kernel.force_design = None
