"""Reduced-rank extrapolation (RRE) steady-state accelerator (counterpart of `sr_for_cfd_tpu/ops/extrapolate.py`).

The outer SIMPLE iteration is a fixed-point map whose slowest error modes
decay like (1 - c dt) per step. RRE collects K+1 state snapshots W
iterations apart, finds the affine combination whose successive
differences cancel (min ||D c||, sum c = 1), and jumps there. The jump
target is a combination of solver iterates and the solver keeps
iterating on it, so a poor jump is corrected, never taken as the answer;
a jump whose result is non-finite or implausibly large is skipped.

Plain PyTorch: the JAX package has no kernel here either (XLA runs it).
The snapshot buffer is a (K+1, n_flat) tensor on the state's device; the
K x K Gram product and solve are `torch.matmul` / `torch.linalg.solve_ex`
with TF32 off. `rre_extrapolate.attempts` and `.taken` count the jumps
tried and applied, so that a run can show that one happened.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import CaseConfig
from .bc import BFSInletProfile, apply_bc, apply_bfs_inlet
from .stencil import FaceFluxes


class RREBuffer(NamedTuple):
    """Snapshot buffer of one chunk."""

    snaps: torch.Tensor  # (K+1, n_flat)
    count: int  # snapshots collected so far


def flat_size(nx: int, ny: int) -> int:
    """Length of the flattened state: three padded fields and the four
    interior face-flux arrays (the fluxes carry the converged Rhie-Chow
    correction, so they are part of the fixed point)."""
    return 3 * (nx + 2) * (ny + 2) + 4 * nx * ny


def flatten_state(u, v, p, ff: FaceFluxes) -> torch.Tensor:
    return torch.cat([
        u.reshape(-1), v.reshape(-1), p.reshape(-1),
        ff.e.reshape(-1), ff.n.reshape(-1), ff.w.reshape(-1), ff.s.reshape(-1),
    ])


def unflatten_state(
    x: torch.Tensor, nx: int, ny: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, FaceFluxes]:
    pad = (nx + 2) * (ny + 2)
    core = nx * ny
    fields = []
    off = 0
    for _ in range(3):
        fields.append(x[off:off + pad].reshape(nx + 2, ny + 2))
        off += pad
    ffs = []
    for _ in range(4):
        ffs.append(x[off:off + core].reshape(nx, ny))
        off += core
    return fields[0], fields[1], fields[2], FaceFluxes(*ffs)


def empty_buffer(depth: int, n_flat: int, dtype, device="cpu") -> RREBuffer:
    return RREBuffer(
        snaps=torch.zeros((depth + 1, n_flat), dtype=dtype, device=device),
        count=0,
    )


def push_snapshot(buf: RREBuffer, flat: torch.Tensor) -> RREBuffer:
    """Write `flat` into row `count` (in place) and count it. A push into
    a full buffer is dropped, as `dynamic_update_slice` clamps it."""
    row = min(buf.count, buf.snaps.shape[0] - 1)
    buf.snaps[row] = flat
    return RREBuffer(snaps=buf.snaps, count=buf.count + 1)


def gram_coeffs(G: torch.Tensor) -> torch.Tensor:
    """Affine-combination coefficients from a (K, K) difference Gram
    matrix: solve (G + ridge I) gamma = 1, c = gamma / sum gamma. The
    ridge is ~sqrt(eps) relative to the mean diagonal: large enough to
    dominate the rounding noise of the Gram entries, small enough not to
    bias the mode cancellation."""
    K = G.shape[0]
    rel = 1e-6 if G.dtype == torch.float32 else 1e-12
    ridge = torch.tensor(rel, dtype=G.dtype, device=G.device) * torch.trace(G) / K
    G = G + ridge * torch.eye(K, dtype=G.dtype, device=G.device)
    # a singular G (zero drift) gives non-finite coefficients, which
    # rre_extrapolate rejects, instead of an exception
    gamma, _ = torch.linalg.solve_ex(
        G, torch.ones((K,), dtype=G.dtype, device=G.device))
    return gamma / torch.sum(gamma)


def rre_extrapolate(snaps: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """Given snapshots x_0..x_K (rows), return (x_star, ok).

    Solves min ||D c||_2 s.t. sum(c) = 1 over the differences
    D = [x_1-x_0, ..., x_K-x_{K-1}] through the normal equations on
    globally scaled differences, then x_star = sum c_i x_{i+1}. `ok` is
    False when x_star is non-finite, the jump exceeds 1e3 times the last
    window's drift, or the drift is zero; the caller then keeps iterating.
    """
    D = snaps[1:] - snaps[:-1]  # (K, n)
    drift = torch.max(torch.abs(D[-1]))
    scale = torch.clamp(drift, min=torch.finfo(snaps.dtype).tiny)
    Dn = D / scale
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        G = Dn @ Dn.T
        c = gram_coeffs(G)
        x_star = c @ snaps[1:]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    jump = torch.max(torch.abs(x_star - snaps[-1]))
    ok = (torch.all(torch.isfinite(x_star)) & (jump <= 1e3 * drift)
          & (drift > 0))
    rre_extrapolate.attempts += 1
    ok = bool(ok.item())
    rre_extrapolate.taken += int(ok)
    return x_star, ok


rre_extrapolate.attempts = 0
rre_extrapolate.taken = 0


def inject_state(
    x_star: torch.Tensor,
    case: CaseConfig,
    profile: Optional[BFSInletProfile],
):
    """Rebuild (u, v, p, ff) from an extrapolated flat vector, with the
    exact boundary conditions reapplied to the ghost ring."""
    nx, ny = case.mesh.nx, case.mesh.ny
    u, v, p, ff = unflatten_state(x_star, nx, ny)
    u = apply_bfs_inlet(apply_bc(u, case.u_bc), 0, profile)
    v = apply_bfs_inlet(apply_bc(v, case.v_bc), 1, profile)
    p = apply_bc(p, case.p_bc)
    return u, v, p, ff
