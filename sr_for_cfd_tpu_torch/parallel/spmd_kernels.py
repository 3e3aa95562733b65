"""The per-rank red-black pressure sweep on the card (counterpart of `sr_for_cfd_tpu/parallel/spmd_pallas.py`).

`shard_rb_sweep` runs `kb` full red-black sweeps on one rank's
halo-extended block and returns its own rows and the last sweep's partial
residual sum of squares, as the TPU kernel of the same name does. One
`2kb`-row halo exchange (`spmd_step.assemble`) buys the kb sweeps: the halo
rows' updates are recomputed redundantly and erode two rows per sweep from
the block's edges, so the own rows are exact when h >= 2kb.

Layout, all in global padded coordinates carried in by `row0` (the rank's
first own interior row, from 0):

* `ext`: (rows + 2h, W), own rows at k in [h, rows + h); W is ny + 2 in the
  SIMPLE step and nyl + 2, with zero columns, in the sharded V-cycle;
* `b_ext`: the frozen right-hand side, halo-extended the same way
  (`extend_b_halo`), zero outside the rank's valid window;
* a cell is valid when its global padded row `row0 + k - (h - 1)` lies in
  [1, nxg] and its column in [1, W - 2]; red is (row + column) even; the
  Laplacian replicates the block's first and last rows; the update is
  `f + r * inv_ap` with `inv_ap = sor / ap` worked out in double;
* `ss`: the last sweep's r1^2 on own red cells plus r2^2 on own black
  cells. The caller sums it over the ranks.

On a CPU tensor the wrapper runs `shard_rb_sweep_plain`, a direct
transcription of `_shard_sweep_kernel` whose sum follows the kernel's fixed
order (32 x 32 tiles of the block's inner cells, 256 terms per tile summed
as the kernel's threads sum them, then the tiles). On a CUDA tensor it
launches the fused form of `csrc/shard_rb.cu` once (the kb sweeps and the
sum, one launch, counted in `shard_rb_sweep.launches`; plan from
`ops/shard_rb.py`) or raises. A kb whose tile does not fit the fused
form's shared memory (kb > 33, `shard_rb.fits`) runs on the same file's
one-sweep form instead: kb one-sweep launches and the sum, kb + 1 counted.
The kernel leaves the block's first and last rows as they are, where the
plain version updates them with the row beyond replicated: both differ
from the global sweep there, by the same erosion, so the own rows and `ss`
agree bit for bit on the card.

`_shard_rb_sweep_staged` is that one-sweep form at every kb (the form
before the fused kernel: kb one-sweep launches between two clones of the
block, then the sum of the partials). The card gates call it, to hold the
fused form bit for bit against it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops import kernel_lib, shard_rb
from .mesh import ring_exchange

# csrc/shard_rb.cu's TILE, which the plain sum follows (the card's bit-equal
# gates fail if the two differ)
TILE = 32
THREADS = 256  # csrc/common.cuh: SRCFD_THREADS


def _refuse_halo(h: int, kb: int) -> None:
    if h < 2 * kb:
        raise ValueError(f"halo depth h={h} cannot buy kb={kb} sweeps "
                         f"(erosion needs h >= {2 * kb})")


def _coefficient(inv_dx2: float, inv_dy2: float, volp: float, sor: float) -> float:
    """sor / ap_d in double, as the TPU kernel works it out."""
    ap = -volp * (2.0 * inv_dx2 + 2.0 * inv_dy2)
    return sor / ap


def _lap(f: torch.Tensor, inv_dx2: float, inv_dy2: float, volp: float):
    """5-point volp-scaled Laplacian with replicated edges."""
    fp = F.pad(f[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    e, w, n, s = fp[2:, 1:-1], fp[:-2, 1:-1], fp[1:-1, 2:], fp[1:-1, :-2]
    return volp * ((e - 2.0 * f + w) * inv_dx2 + (n - 2.0 * f + s) * inv_dy2)


@functools.lru_cache(maxsize=64)
def _masks(R: int, W: int, row0: int, nxg: int, h: int, device: torch.device):
    """(red, black, own) of a block: valid cells by colour, own rows."""
    kk = torch.arange(R, device=device)[:, None]
    jj = torch.arange(W, device=device)[None, :]
    i_pad = row0 + kk - (h - 1)
    valid = (i_pad >= 1) & (i_pad <= nxg) & (jj >= 1) & (jj <= W - 2)
    red = valid & ((i_pad + jj) % 2 == 0)
    black = valid & ((i_pad + jj) % 2 == 1)
    own = (kk >= h) & (kk < R - h)
    return red, black, own


def _fixed_sum(x: torch.Tensor) -> torch.Tensor:
    """(n, m) -> (n,): what `srcfd_fixed_sum` gives for each row: thread t
    adds elements t, t + 256, ... in turn, then the tree of
    `srcfd_block_sum`."""
    n, m = x.shape
    pad = -m % THREADS
    if pad:
        x = torch.cat([x, x.new_zeros((n, pad))], dim=1)
    x = x.reshape(n, -1, THREADS)
    acc = x[:, 0]
    for q in range(1, x.shape[1]):
        acc = acc + x[:, q]
    s = THREADS // 2
    while s >= 1:
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


def _tile_sum(terms: torch.Tensor) -> torch.Tensor:
    """The kernel's sum of a (R, W) array of per-cell terms, zero on the
    block's edges: per 32 x 32 tile of the inner cells in the thread order
    of its black loop, then over the tiles in launch-grid order."""
    terms = terms[1:-1, 1:-1]
    R, W = terms.shape
    ty, tx = -(-R // TILE), -(-W // TILE)
    t = torch.zeros((ty * TILE, tx * TILE), dtype=terms.dtype, device=terms.device)
    t[:R, :W] = terms
    tiles = t.reshape(ty, TILE, tx, TILE).permute(0, 2, 1, 3).reshape(ty * tx, TILE * TILE)
    partials = _fixed_sum(tiles)
    return _fixed_sum(partials[None])[0]


def shard_rb_sweep_plain(ext: torch.Tensor, b_ext: torch.Tensor, row0: int, *,
                         nxg: int, inv_dx2: float, inv_dy2: float, volp: float,
                         sor: float, h: int = 2, kb: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (own rows, ss)."""
    _refuse_halo(h, kb)
    f, b = ext, b_ext
    R, W = f.shape
    rows = R - 2 * h
    red, black, own = _masks(R, W, row0, nxg, h, f.device)
    inv_ap = _coefficient(inv_dx2, inv_dy2, volp, sor)

    r1 = r2 = None
    for _ in range(kb):
        r1 = b - _lap(f, inv_dx2, inv_dy2, volp)
        f = f + torch.where(red, r1 * inv_ap, 0.0)
        r2 = b - _lap(f, inv_dx2, inv_dy2, volp)
        f = f + torch.where(black, r2 * inv_ap, 0.0)

    terms = (torch.where(own & red, r1 * r1, 0.0)
             + torch.where(own & black, r2 * r2, 0.0))
    return f[h:rows + h], _tile_sum(terms)


def _check_block(ext: torch.Tensor, b_ext: torch.Tensor, h: int) -> None:
    for name, t in (("ext", ext), ("b_ext", b_ext)):
        if t.device != ext.device:
            raise ValueError(f"{name} is on {t.device}, ext on {ext.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the per-rank sweep kernel is float32-only, "
                             f"got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the per-rank sweep kernel takes contiguous "
                             f"blocks, got {name} with strides {t.stride()}")
    if ext.dim() != 2 or b_ext.shape != ext.shape:
        raise ValueError(f"expected ext and b_ext of one (rows + 2h, W) shape, "
                         f"got {tuple(ext.shape)} and {tuple(b_ext.shape)}")
    if ext.shape[0] <= 2 * h or ext.shape[1] < 3:
        raise ValueError(f"a ({ext.shape[0]}, {ext.shape[1]}) block has no own "
                         f"rows inside a {h}-row halo")


@functools.lru_cache(maxsize=64)
def _fused_params(R: int, W: int, h: int, kb: int, nxg: int, inv_dx2: float,
                  inv_dy2: float, volp: float, inv_ap: float, device: torch.device):
    """(the parameter block's address, (the block, its partials, its
    ticket)) of one call site. The entry owns every tensor whose address
    the block holds, so that none is freed while the block can still be
    launched; the ticket starts at 0 and the kernel's last block resets it."""
    partials = torch.empty(shard_rb.n_partials(R, W), dtype=torch.float32, device=device)
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    params = shard_rb.make_params(
        shard_rb.shard_rb_plan(R, W, h, kb), R, W, nxg=nxg, h=h, mode=2,
        inv_dx2=inv_dx2, inv_dy2=inv_dy2, volp=volp, inv_ap=inv_ap,
        partials=partials.data_ptr(), ticket=ticket.data_ptr())
    return ctypes.addressof(params), (params, partials, ticket)


def _on_card(ext: torch.Tensor, b_ext: torch.Tensor, h: int) -> None:
    if ext.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {ext.device}")
    _check_block(ext, b_ext, h)


def shard_rb_sweep(ext: torch.Tensor, b_ext: torch.Tensor, row0: int, *,
                   nxg: int, inv_dx2: float, inv_dy2: float, volp: float,
                   sor: float, h: int = 2, kb: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`kb` full red-black sweeps on a rank's halo-extended block; returns
    (own rows (rows, W), ss (a 0-d tensor on the block's device))."""
    _refuse_halo(h, kb)
    if ext.device.type == "cpu":
        return shard_rb_sweep_plain(ext, b_ext, row0, nxg=nxg, inv_dx2=inv_dx2,
                                    inv_dy2=inv_dy2, volp=volp, sor=sor, h=h, kb=kb)
    _on_card(ext, b_ext, h)
    inv_ap = _coefficient(inv_dx2, inv_dy2, volp, sor)
    if not shard_rb.fits(kb):
        result = _one_sweep_form(ext, b_ext, row0, nxg, h, kb, inv_dx2, inv_dy2, volp,
                                 inv_ap)
        shard_rb_sweep.launches += kb + 1
        return result
    lib = kernel_lib.load_library()
    R, W = ext.shape
    addr, _ = _fused_params(R, W, h, kb, nxg, inv_dx2, inv_dy2, volp, inv_ap, ext.device)
    out = torch.empty((R - 2 * h, W), dtype=torch.float32, device=ext.device)
    ss = torch.empty((), dtype=torch.float32, device=ext.device)
    kernel_lib.check(lib.srcfd_shard_rb_fused(
        addr, ext.data_ptr(), out.data_ptr(), b_ext.data_ptr(), ss.data_ptr(), row0,
        kernel_lib.stream_ptr(ext.device)), "shard_rb_fused")
    shard_rb_sweep.launches += 1
    return out, ss


shard_rb_sweep.launches = 0


def _shard_rb_sweep_staged(ext: torch.Tensor, b_ext: torch.Tensor, row0: int, *,
                           nxg: int, inv_dx2: float, inv_dy2: float, volp: float,
                           sor: float, h: int = 2, kb: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-rank sweep before the fused form: kb one-sweep launches of
    `csrc/shard_rb.cu` between two clones of the block, then the sum of the
    last one's partials (kb + 1 launches, counted in
    `_shard_rb_sweep_staged.launches`). Card only; the gates hold
    `shard_rb_sweep` against it."""
    _refuse_halo(h, kb)
    _on_card(ext, b_ext, h)
    result = _one_sweep_form(ext, b_ext, row0, nxg, h, kb, inv_dx2, inv_dy2, volp,
                             _coefficient(inv_dx2, inv_dy2, volp, sor))
    _shard_rb_sweep_staged.launches += kb + 1
    return result


_shard_rb_sweep_staged.launches = 0


def _one_sweep_form(ext, b_ext, row0, nxg, h, kb, inv_dx2, inv_dy2, volp, inv_ap):
    """kb launches of the one-sweep kernel and the sum of the last one's
    partials, on a checked block; the callers count the kb + 1 launches."""
    lib = kernel_lib.load_library()
    R, W = ext.shape
    rows = R - 2 * h
    stream = kernel_lib.stream_ptr(ext.device)
    n_part = lib.srcfd_shard_rb_partials(R, W)
    partials = torch.empty(n_part, dtype=torch.float32, device=ext.device)
    ss = torch.empty(1, dtype=torch.float32, device=ext.device)
    # the kernel writes the inner cells only: the buffers carry ext's edges
    bufs = [ext.clone() for _ in range(min(kb, 2))]
    src = ext
    for s in range(kb):
        dst = bufs[s % 2]
        kernel_lib.check(lib.srcfd_shard_rb_sweep(
            src.data_ptr(), dst.data_ptr(), b_ext.data_ptr(), partials.data_ptr(),
            R, W, row0, nxg, h, rows, inv_dx2, inv_dy2, volp, inv_ap,
            int(s == kb - 1), stream), "shard_rb_sweep")
        src = dst
    kernel_lib.check(lib.srcfd_sum_finalize(partials.data_ptr(), n_part,
                                            ss.data_ptr(), stream), "sum_finalize")
    return src[h:rows + h], ss[0]


def extend_b_halo(b: torch.Tensor, group=None, h: int = 2) -> torch.Tensor:
    """(rows, ny) frozen pressure RHS -> (rows + 2h, ny + 2), zero outside
    this rank's valid window. Runs once per pressure solve (b is frozen for
    the whole loop); only the field travels per block. Needs h <= rows."""
    rows, ny = b.shape
    top, bot = ring_exchange(b[-h:], b[:h], group)
    bx = torch.cat([top, b, bot], dim=0)
    zc = b.new_zeros((rows + 2 * h, 1))
    return torch.cat([zc, bx, zc], dim=1)
