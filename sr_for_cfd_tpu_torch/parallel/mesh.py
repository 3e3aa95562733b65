"""The rank ring and the collectives of the row-decomposed solver (counterpart of `sr_for_cfd_tpu/parallel/mesh.py`).

The JAX package decomposes over a 1-D device mesh axis 'x' and moves halo
rows with `lax.ppermute` over `ring_perms`; here the ranks of a
`torch.distributed` process group (`group`, the world group by default)
form the ring, and the same primitives are plain functions:

* `ring_exchange(send_up, send_dn)` returns `(from_up, from_dn)`: the
  previous rank's `send_up` and the next rank's `send_dn`, as `ppermute`
  over the forward and backward perms gives them. A boundary rank trades
  only across its interior side and gets zeros on the open side. JAX's
  ring wraps around there instead, but every reader of that side discards
  it (`spmd_step.py:285-297`, `extend_consts` :398-409,
  `spmd_pallas.py:132-141`), so the results are the same
  (`tests/test_torch_spmd.py`).
* `psum` and `pmax` are `all_reduce` with SUM and MAX, `all_gather`
  concatenates the ranks' bands along rows.

The group's backend has to suit the tensors: gloo for CPU tensors, NCCL for
CUDA ones. A tensor on the wrong kind of device raises; nothing falls back.

`COUNTS` counts the calls (`exchanges`, `all_reduce`, `all_gather`) and
the point-to-point messages posted (`p2p`), so that a run can report its
collectives per step. The JAX package's `make_mesh`, `batch_sharding`,
`replicated` and `grid_sharding` belong to its GSPMD path
(`parallel/domain.py`), which is not ported (ROADMAP queue A, item A11).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

AXIS = "x"  # the ring's name in messages: the JAX package's mesh axis
COUNTS = {"exchanges": 0, "p2p": 0, "all_reduce": 0, "all_gather": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def rank_of(group=None) -> int:
    return dist.get_rank(group)


def size_of(group=None) -> int:
    return dist.get_world_size(group)


def check_backend(device: torch.device, group=None) -> None:
    """Raise unless the group's backend moves tensors of `device`: gloo
    for the CPU, NCCL for CUDA."""
    backend = dist.get_backend(group)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(
            f"{device.type} tensors need a {want} process group, got "
            f"{backend!r} (init_process_group(backend={want!r}, ...))")


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def ring_exchange(send_up: torch.Tensor, send_dn: torch.Tensor,
                  group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(from_up, from_dn): the previous rank's `send_up` and the next
    rank's `send_dn`; zeros where there is no such rank."""
    rank, n = rank_of(group), size_of(group)
    send_up, send_dn = send_up.contiguous(), send_dn.contiguous()
    from_up = torch.zeros_like(send_up)
    from_dn = torch.zeros_like(send_dn)
    ops = []
    if rank > 0:
        ops.append(dist.P2POp(dist.isend, send_dn, _peer(group, rank - 1), group))
        ops.append(dist.P2POp(dist.irecv, from_up, _peer(group, rank - 1), group))
    if rank < n - 1:
        ops.append(dist.P2POp(dist.isend, send_up, _peer(group, rank + 1), group))
        ops.append(dist.P2POp(dist.irecv, from_dn, _peer(group, rank + 1), group))
    COUNTS["exchanges"] += 1
    if ops:
        COUNTS["p2p"] += len(ops)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_up, from_dn


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks (a new tensor; `x` is left as it is)."""
    out = x.clone()
    COUNTS["all_reduce"] += 1
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Maximum over the ranks (a new tensor)."""
    out = x.clone()
    COUNTS["all_reduce"] += 1
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' `x` stacked along rows in rank order (`all_gather` with
    `tiled=True`)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size_of(group))]
    COUNTS["all_gather"] += 1
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


def init_single_rank(device, init_dir: str) -> None:
    """A one-rank world (rank 0 of 1) through a `file://` store in
    `init_dir`: the way to run the row-decomposed solver on one card or
    one CPU process. The backend follows the device."""
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_dir}/store",
                            rank=0, world_size=1)
