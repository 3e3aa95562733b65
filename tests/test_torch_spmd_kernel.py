"""The per-rank red-black sweep's plain version (`parallel/spmd_kernels.py`,
the CUDA kernel's twin) against the JAX package's `shard_rb_sweep` in
interpret mode, on the CPU, without processes.

Blocks are cut from seeded whole fields of a 32x16 grid split over four
ranks, as `spmd_step.assemble` cuts them (neighbour rows inside the
domain, the ghost row repeated beyond it). Own rows must agree within
1e-6 of max|f| and `ss` within 1e-6 relative: not bit for bit, because
XLA:CPU contracts the Laplacian's multiply-adds into FMAs and the port
does not (on the card the kernel is built with -fmad=false and equals
its plain version bit for bit, `tests/test_torch_cuda.py`).
"""

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu_torch.parallel import spmd_kernels
from sr_for_cfd_tpu_torch.parallel.spmd_kernels import (
    extend_b_halo,
    shard_rb_sweep,
    shard_rb_sweep_plain,
)

torch.set_num_threads(1)

NX, NY, WORLD = 32, 16, 4
ROWS = NX // WORLD
COEF = dict(nxg=NX, inv_dx2=float(NX * NX) / 100.0, inv_dy2=float(NY * NY) / 9.0,
            volp=(10.0 / NX) * (3.0 / NY), sor=1.8)


def _fields():
    g = np.random.default_rng(2026)
    p = g.standard_normal((NX + 2, NY + 2)).astype(np.float32)
    b = g.standard_normal((NX, NY)).astype(np.float32) * 50.0
    return p, b


def _block(p, b, rank, h):
    """(ext, b_ext) of `rank` with an h-row halo: padded rows
    1 + rank*ROWS - h .. clamped to the ghost rows; b zero outside the
    interior rows and on the two y-ghost columns."""
    idx = np.clip(np.arange(1 + rank * ROWS - h, 1 + (rank + 1) * ROWS + h), 0, NX + 1)
    ext = p[idx]
    bp = np.zeros((NX + 2, NY + 2), np.float32)
    bp[1:-1, 1:-1] = b
    b_idx = np.arange(1 + rank * ROWS - h, 1 + (rank + 1) * ROWS + h)
    inside = (b_idx >= 1) & (b_idx <= NX)
    b_ext = np.where(inside[:, None], bp[np.clip(b_idx, 0, NX + 1)], 0.0).astype(np.float32)
    return ext, b_ext


@pytest.mark.parametrize("rank", [0, 1, WORLD - 1])
@pytest.mark.parametrize("kb,h", [(1, 2), (2, 4), (3, 6), (1, 3)])
def test_plain_sweep_matches_jax(rank, kb, h):
    import jax.numpy as jnp

    from sr_for_cfd_tpu.parallel.spmd_pallas import shard_rb_sweep as jax_sweep

    p, b = _fields()
    ext, b_ext = _block(p, b, rank, h)
    j_own, j_ss = jax_sweep(jnp.asarray(ext), jnp.asarray(b_ext),
                            jnp.full((1, 1), rank * ROWS, jnp.int32), h=h, kb=kb,
                            interpret=True, **COEF)
    t_own, t_ss = shard_rb_sweep(torch.as_tensor(ext), torch.as_tensor(b_ext),
                                 rank * ROWS, h=h, kb=kb, **COEF)
    assert t_own.shape == (ROWS, NY + 2)
    scale = float(np.max(np.abs(np.asarray(j_own))))
    assert float(np.max(np.abs(t_own.numpy() - np.asarray(j_own)))) <= 1e-6 * scale
    assert abs(float(t_ss) - float(j_ss)) <= 1e-6 * abs(float(j_ss))


def test_own_rows_exact_against_the_whole_grid():
    """Erosion: with h = 2kb the own rows of every rank, stitched, equal kb
    red-black sweeps of the whole grid with its ghost ring frozen (the same
    plain arithmetic on the whole field, as one block whose first and last
    rows repeat the ghost rows)."""
    p, b = _fields()
    kb, h = 3, 6
    b_whole = np.zeros((NX + 4, NY + 2), np.float32)
    b_whole[2:-2, 1:-1] = b
    f = torch.as_tensor(p)
    for _ in range(kb):
        ext = torch.cat([f[:1], f, f[-1:]])
        inner, _ = shard_rb_sweep_plain(ext, torch.as_tensor(b_whole), 0, h=2, kb=1,
                                        **COEF)
        f = torch.cat([f[:1], inner, f[-1:]])
    own = []
    for rank in range(WORLD):
        ext, b_ext = _block(p, b, rank, h)
        own.append(shard_rb_sweep_plain(torch.as_tensor(ext), torch.as_tensor(b_ext),
                                        rank * ROWS, h=h, kb=kb, **COEF)[0])
    assert torch.equal(torch.cat(own), f[1:-1])


def test_extend_b_halo_matches_jax(monkeypatch):
    """The port's halo extension of the frozen right-hand side, each rank
    fed its neighbours' rows, against JAX's under shard_map on a 4-device
    mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from sr_for_cfd_tpu.parallel.mesh import make_mesh, ring_perms
    from sr_for_cfd_tpu.parallel.spmd_pallas import extend_b_halo as jax_extend

    _, b = _fields()
    h = 4
    fwd, bwd = ring_perms(WORLD)

    def body(bb):
        rank = jax.lax.axis_index("x")
        return jax_extend(bb, "x", fwd, bwd, rank, WORLD, h=h)

    ref = np.asarray(jax.jit(jax.shard_map(
        body, mesh=make_mesh(WORLD, "x"), in_specs=P("x", None),
        out_specs=P("x", None)))(jnp.asarray(b)))
    ref = ref.reshape(WORLD, ROWS + 2 * h, NY + 2)
    for rank in range(WORLD):
        def exchange(send_up, send_dn, group=None, rank=rank):
            up = (torch.as_tensor(b[rank * ROWS - h:rank * ROWS]) if rank > 0
                  else torch.zeros_like(send_up))
            dn = (torch.as_tensor(b[(rank + 1) * ROWS:(rank + 1) * ROWS + h])
                  if rank < WORLD - 1 else torch.zeros_like(send_dn))
            return up, dn

        monkeypatch.setattr(spmd_kernels, "ring_exchange", exchange)
        band = torch.as_tensor(b[rank * ROWS:(rank + 1) * ROWS])
        np.testing.assert_array_equal(extend_b_halo(band, h=h).numpy(), ref[rank])


def test_halo_refusal_text_matches_jax():
    import jax.numpy as jnp

    from sr_for_cfd_tpu.parallel.spmd_pallas import shard_rb_sweep as jax_sweep

    ext = np.zeros((ROWS + 6, NY + 2), np.float32)
    with pytest.raises(ValueError) as j:
        jax_sweep(jnp.asarray(ext), jnp.asarray(ext), jnp.zeros((1, 1), jnp.int32),
                  h=3, kb=2, interpret=True, **COEF)
    with pytest.raises(ValueError) as t:
        shard_rb_sweep(torch.as_tensor(ext), torch.as_tensor(ext), 0, h=3, kb=2, **COEF)
    assert str(t.value) == str(j.value)
