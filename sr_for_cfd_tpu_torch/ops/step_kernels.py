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
* Design (b): a few launches per step. Each momentum loop runs on the
  fused momentum pass (`csrc/mom_pass.cu`, `ops/mom_pass.py`): one launch
  per check of `momentum_check_every` sweeps and its residual sum, the
  loop's exit (its test on the best rms, `pallas_step.py:247-252`)
  decided on the card; the host enqueues BATCH launches and reads the
  loop state once per batch, not ahead (a north-star solve runs ~4.2
  sweeps). Then one launch relaxes each field and fills its ring, one
  computes the face fluxes, and one projects, takes the three residual
  sums and fills the rings of u and v. The pressure stage is
  `ops/mg_kernels.py` (multigrid mode: the same frozen-ghost system as the
  TPU kernel's embedded V-cycle) or `ops/pressure_kernels.py` (point
  iteration, omega clamped as in the TPU kernel, and `rb_sor.cu` in its
  divide form, (sor r) / ap_d, as `pallas_step.py:309`). This is the
  400x400 fine phases, and any point-iteration grid too large for (a). A
  `momentum_check_every` past the fused pass's shared memory runs its
  momentum on the staged form's half-sweeps.
  The staged form (`_staged=True`, design (b) before the fused pass: a
  launch per momentum half-sweep with a finalize and a host read per
  check, and a launch per relaxation, boundary fill, projection and sum)
  stays as the card gates' bit-equality reference.
* Design (a) over a case axis (`simple_step_small_batched`, the
  data-generation sweep's counterpart of JAX's vmapped `pallas_call`):
  one launch for every listed case of a stacked batch, a block per case
  with its own nu, each block running (a)'s body on its case; the cases
  not listed keep their inputs. At 10x10 or 50x50 a case's block holds
  one SM, so 8 cases take one launch on 8 SMs.
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
launches of `fused_step.cu` and `mom_pass.cu` kernels (no-op ones
included; the pressure stage of (b) counts on its own wrappers; a
batched launch counts once), `.reads` the host reads of the momentum
loops' rms or state, `.calls` the calls on the card;
`simple_step_small_batched.launches` counts the batched launches alone.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DIRICHLET, QUICK, CaseConfig
from . import kernel_lib, mom_pass
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


def _momentum_residual(f0, ff, case: CaseConfig, nu):
    """The kernel's momentum residual in plain PyTorch: f -> (r, ap) on the
    interior, with f0 the step-entry field."""
    mesh, st = case.mesh, case.settings
    volp, dt = mesh.volp, st.dt
    inv_dx2, inv_dy2, ap_d, _ = _coefficients(case)
    quick = st.scheme == QUICK
    signs = flux_signs(ff)
    ap = volp / dt + (quick_diag if quick else upwind_diag)(ff, volp, signs) - nu * ap_d
    flux = quick_flux if quick else upwind_flux
    f0_int = f0[1:-1, 1:-1]

    def residual(f):
        fd = _laplacian(f, volp, inv_dx2, inv_dy2)
        return -(volp / dt * (f[1:-1, 1:-1] - f0_int) + flux(f, ff, signs) - nu * fd), ap

    return residual


def _plain_momentum(f0, ff, case: CaseConfig, nu):
    """The momentum loop of one field in plain PyTorch (the kernel's
    arithmetic): returns (f, sweeps_run)."""
    mesh, st = case.mesh, case.settings
    return sweep_loop(f0, _momentum_residual(f0, ff, case, nu), nx=mesh.nx, ny=mesh.ny,
                      tol=st.inner_tolerance, max_iter=st.inner_max_iter,
                      check_every=max(1, st.momentum_check_every))


def _plain_one_step(u0, v0, p0, ff, case: CaseConfig, profile, nu):
    mesh, fluid, st = case.mesh, case.fluid, case.settings
    nx, ny = mesh.nx, mesh.ny
    dx, dy, volp, dt, rho = mesh.dx, mesh.dy, mesh.volp, st.dt, fluid.rho
    inv_dx2, inv_dy2, ap_d, sor = _coefficients(case)
    loop = dict(nx=nx, ny=ny, tol=st.inner_tolerance, max_iter=st.inner_max_iter)

    u, u_it = _plain_momentum(u0, ff, case, nu)
    u = under_relax(u, u0[1:-1, 1:-1], st.relax("u"))
    u = apply_bfs_inlet(apply_bc(u, case.u_bc), 0, profile)
    v, v_it = _plain_momentum(v0, ff, case, nu)
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
    _launch(lib.srcfd_step_small_batched(
        *map(_ptr, (u, v, p, *ff, u_in, below, nu)), ctypes.addressof(prm),
        *map(_ptr, (*outs, *fouts, res, counts)), None, 1, stream), "step_small")
    return (*outs, FaceFluxes(*fouts), res, [int(x) for x in counts.tolist()])


# momentum checks (launches of momentum_check_every sweeps) enqueued per
# host read of the loop state, not ahead: 96% of the north star's fine
# solves run 3 to 6 sweeps (PERF.md), so one batch holds nearly all
BATCH = 6


class _Staged:
    """Design (b): device buffers and stage launches of one call. `staged`
    runs the staged form (the gates' reference); a momentum_check_every
    past the fused pass's shared memory runs its momentum on the staged
    half-sweeps."""

    def __init__(self, lib, case: CaseConfig, prm, u_in, below, nu, like,
                 staged: bool = False):
        self.lib, self.case, self.prm = lib, case, prm
        self.u_in, self.below, self.nu = u_in, below, nu
        self.stream = kernel_lib.stream_ptr(like.device)
        nx2, ny2 = like.shape
        dev = like.device
        st = case.settings
        k, quick = max(1, st.momentum_check_every), st.scheme == QUICK
        self.staged = staged
        self.host_exit = staged or not mom_pass.fits(k, quick)
        self.n_mom = lib.srcfd_step_mom_partials(nx2, ny2)
        self.n_proj = lib.srcfd_step_proj_partials(nx2, ny2)
        self.mom_part = torch.empty(2 * self.n_mom, dtype=torch.float32, device=dev)
        self.proj_part = torch.empty(3 * self.n_proj, dtype=torch.float32, device=dev)
        self.rms_dev = torch.empty(1, dtype=torch.float32, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.n_cells = float((nx2 - 2) * (ny2 - 2))
        if not self.host_exit:
            coef = mom_pass.Coef(prm.volp, prm.volp_dt, prm.inv_dx2, prm.inv_dy2, prm.ap_d)
            self.loop = mom_pass.cached_loop(
                nx2, ny2, str(dev), quick, k, True, coef, float(st.inner_tolerance),
                int(st.inner_max_iter), True, BATCH, False, simple_step_kernel)

    def momentum(self, f0: torch.Tensor, ff: FaceFluxes) -> Tuple[torch.Tensor, int]:
        """The red-black momentum loop: (the result, or f0 when no sweep
        ran; sweeps run)."""
        if self.host_exit:
            return self.momentum_host_exit(f0, ff)
        return self.loop.solve(f0, f0, ff, self.nu)

    def momentum_host_exit(self, f0: torch.Tensor, ff: FaceFluxes) -> Tuple[torch.Tensor, int]:
        """The staged momentum loop: half-sweep launches, a finalize and a
        host read per check, the exit decided on the host."""
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
            simple_step_kernel.reads += 1
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
        """The staged form: relaxation, then the boundary fill, in place."""
        nx2, ny2 = f.shape
        if alpha != 1.0:
            _launch(self.lib.srcfd_step_relax(_ptr(f), _ptr(f0), nx2, ny2, alpha,
                                              self.stream), "step_relax")
        self.bc(f, var)

    def relaxed(self, src, f0, alpha: float, var: int) -> torch.Tensor:
        """Relaxation and boundary fill in one launch, into a new field."""
        dst = torch.empty_like(f0)
        _launch(self.lib.srcfd_step_relax_bc(
            _ptr(src), _ptr(f0), _ptr(dst), alpha, int(alpha != 1.0), var,
            _ptr(self.u_in), _ptr(self.below), ctypes.addressof(self.prm), self.stream),
            "step_relax_bc")
        return dst

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

    def fluxes(self, u, v, like: FaceFluxes) -> FaceFluxes:
        ff = FaceFluxes(*(torch.empty_like(t) for t in like))
        _launch(self.lib.srcfd_step_fluxes(_ptr(u), _ptr(v), *map(_ptr, ff),
                                           ctypes.addressof(self.prm), self.stream),
                "step_fluxes")
        return ff

    def step(self, u0, v0, p0, ff: FaceFluxes):
        if self.staged:
            return self.step_staged(u0, v0, p0, ff)
        st = self.case.settings
        u_m, u_it = self.momentum(u0, ff)
        u = self.relaxed(u_m, u0, st.relax("u"), 0)
        v_m, v_it = self.momentum(v0, ff)
        v = self.relaxed(v_m, v0, st.relax("v"), 1)
        ff = self.fluxes(u, v, ff)
        p_s, p_it = self.pressure(p0, ff)
        p = self.relaxed(p_s, p0, st.relax("p"), 2)
        res = torch.empty(3, dtype=torch.float32, device=u.device)
        _launch(self.lib.srcfd_step_project_bc(
            _ptr(u), _ptr(v), _ptr(p), _ptr(u0), _ptr(v0), _ptr(p0), *map(_ptr, ff),
            _ptr(self.proj_part), _ptr(self.ticket), _ptr(res), _ptr(self.u_in),
            _ptr(self.below), ctypes.addressof(self.prm), self.stream), "step_project_bc")
        return u, v, p, ff, res, (u_it, v_it, p_it)

    def step_staged(self, u0, v0, p0, ff: FaceFluxes):
        st = self.case.settings
        prm = ctypes.addressof(self.prm)
        u, u_it = self.momentum_host_exit(u0, ff)
        self.relax_bc(u, u0, st.relax("u"), 0)
        v, v_it = self.momentum_host_exit(v0, ff)
        self.relax_bc(v, v0, st.relax("v"), 1)
        ff = self.fluxes(u, v, ff)
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
                       _design: Optional[str] = None, _staged: bool = False) -> StepResult:
    """`steps_per_kernel` whole outer steps; returns (u, v, p, ff,
    res_sums[3], counts[3]). `_design` ('a' or 'b', else
    `simple_step_kernel.force_design`) forces a design; by default (a)
    takes point-iteration grids that fit one block's shared memory and (b)
    the rest. `_staged` runs design (b)'s staged form (the card gates hold
    design (b) against it)."""
    if u.device.type == "cpu":
        return simple_step_plain(u, v, p, ff, case, profile, nu=nu)
    for name, t in (("u", u), ("v", v), ("p", p)):
        kernel_lib.check_field(t, f"fused-step ({name})")
    simple_step_kernel.calls += 1
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
    staged = _Staged(lib, case, prm, u_in, below, nu, u, staged=_staged)
    counts = [0, 0, 0]
    res = None
    for _ in range(prm.k_steps):
        u, v, p, ff, res, cnt = staged.step(u, v, p, ff)
        counts = [a + b for a, b in zip(counts, cnt)]
    return u, v, p, ff, res, counts


simple_step_kernel.launches = 0
simple_step_kernel.reads = 0
simple_step_kernel.calls = 0


# design (a)'s shared memory (`fused_step.cu:small_smem_bytes`) and its
# limit (`kSmallSmemMax`: the 227 KB a block may take, less the kernel's
# reduction scratch), for the routing on the CPU
SMALL_SMEM_MAX = 232448 - 2 * 256 * 4


def small_fits(nx2: int, ny2: int) -> bool:
    """`srcfd_step_small_fits` in Python: design (a) takes a padded
    (nx2, ny2) grid."""
    return (12 * nx2 * ny2 + 2 * ny2) * 4 <= SMALL_SMEM_MAX


def simple_step_small_batched(u, v, p, ff: FaceFluxes, case: CaseConfig,
                              profile: Optional[BFSInletProfile], nu,
                              cases) -> StepResult:
    """Design (a) over a case axis: `steps_per_kernel` steps of each listed
    case in one launch, a block per case (`srcfd_step_small_batched`).

    u, v, p are stacked (n, nx+2, ny+2), the face fluxes (n, nx, ny), nu
    (n,); `cases` lists the indices to run. Returns (u, v, p, ff, res
    (n, 3), counts (n, 3)) as tensors on the fields' device, with the
    inputs of the cases not listed (and zero res and counts there): JAX's
    `jnp.where(active, new, old)` over the vmapped step. Only
    point-iteration grids that fit one block's shared memory. On a CPU
    tensor the plain version runs each listed case in turn."""
    n = u.shape[0]
    cases = [int(b) for b in cases]
    if any(b < 0 or b >= n for b in cases) or len(set(cases)) != len(cases):
        raise ValueError(f"case indices must be distinct and in [0, {n}), got {cases}")
    nx2, ny2 = u.shape[1:]
    if case.settings.pressure_solver == "multigrid" or not small_fits(nx2, ny2):
        raise ValueError("the batched step runs design (a): the point-iteration "
                         "pressure mode on grids that fit one block's shared memory")
    outs = [t.clone() for t in (u, v, p)]
    fouts = [t.clone() for t in ff]
    res = torch.zeros((n, 3), dtype=u.dtype, device=u.device)
    counts = torch.zeros((n, 3), dtype=torch.int32, device=u.device)
    if u.device.type == "cpu":
        for b in cases:
            out = simple_step_plain(u[b], v[b], p[b], FaceFluxes(*(t[b] for t in ff)),
                                    case, profile, nu=nu[b])
            for dst, src in zip((*outs, *fouts), (*out[:3], *out[3])):
                dst[b] = src
            res[b] = out[4]
            counts[b] = torch.tensor(out[5], dtype=torch.int32)
        return (*outs, FaceFluxes(*fouts), res, counts)
    for name, t in (("u", u), ("v", v), ("p", p)):
        kernel_lib.check_field(t, f"batched fused-step ({name})", shape=(n, nx2, ny2))
    for t in ff:
        kernel_lib.check_field(t, "batched fused-step (face fluxes)",
                               shape=(n, nx2 - 2, ny2 - 2))
    nu = nu.to(device=u.device, dtype=torch.float32).reshape(n).contiguous()
    if not cases:
        return (*outs, FaceFluxes(*fouts), res, counts)
    lib = kernel_lib.load_library()
    prm = step_params(case, profile is not None)
    u_in, below = _inlet(profile, u[0])
    idx = torch.tensor(cases, dtype=torch.int32).to(u.device, non_blocking=True)
    kernel_lib.check(lib.srcfd_step_small_batched(
        *map(_ptr, (u, v, p, *ff, u_in, below, nu)), ctypes.addressof(prm),
        *map(_ptr, (*outs, *fouts, res, counts, idx)), len(cases),
        kernel_lib.stream_ptr(u.device)), "step_small_batched")
    simple_step_small_batched.launches += 1
    simple_step_kernel.launches += 1
    simple_step_kernel.calls += 1
    return (*outs, FaceFluxes(*fouts), res, counts)


simple_step_small_batched.launches = 0
# 'b' makes every call through the solver take design (b): the tests and
# chip_smoke.py drive (b) at small sizes with it
simple_step_kernel.force_design = None
