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
collectives per step.

A `Mesh` is the port's `jax.sharding.Mesh`: ranks of the default process
group with axis names and a shape, and the process group over them.
`make_mesh(n, axis)` takes the first n ranks; without a process group it is
the one-rank mesh of this process, on which the collectives above are
plain copies. Every function here takes a `Mesh` where it takes a `group`.
`batch_sharding`, `replicated` and `grid_sharding` say which block of a
leading axis a rank holds; `grid_sharding` splits the padded (nx + 2) rows
of a solver field, the split of `parallel/domain.ShardedSolver`.

`census()` records what the collectives move, for the traffic census of
`parallel/comm_budget.py`: while it is open, each call adds (primitive,
payload bytes) to the scope of the loop it runs in. A `ring_exchange`
counts as the JAX package's two `ppermute`s, one a direction, each with its
payload. The solvers mark their inner loops with `inner_loop()`, which costs
one context manager per inner solve when no census is open.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

AXIS = "x"  # the ring's name in messages: the JAX package's mesh axis
COUNTS = {"exchanges": 0, "p2p": 0, "all_reduce": 0, "all_gather": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class Census:
    """What the collectives of a run moved: `top` holds the (primitive,
    payload bytes) records made outside any inner loop, `loops` one
    [records, trips] pair per inner loop in program order. An inner loop
    stops after `trip_cap` trips, so that a census costs a few trips of
    each loop whatever the flow."""

    def __init__(self, trip_cap: int):
        self.trip_cap = trip_cap
        self.top: List[Tuple[str, int]] = []
        self.loops: List[list] = []
        self._inside = False


_CENSUS: Optional[Census] = None


@contextlib.contextmanager
def census(trip_cap: int):
    """Record the collectives run inside the block into the yielded
    `Census`."""
    global _CENSUS
    if _CENSUS is not None:
        raise RuntimeError("a census is already recording")
    _CENSUS = Census(trip_cap)
    try:
        yield _CENSUS
    finally:
        _CENSUS = None


def _always() -> bool:
    return True


@contextlib.contextmanager
def inner_loop():
    """Mark an inner solve's loop. Yields `trip()`, which the loop calls
    as the last test before each trip: without a census it is always
    True; under one it counts the trip, and it is False once the census's
    trip cap is reached."""
    c = _CENSUS
    if c is None:
        yield _always
        return
    loop = [[], 0]
    c.loops.append(loop)

    def trip() -> bool:
        if loop[1] >= c.trip_cap:
            return False
        loop[1] += 1
        return True

    c._inside = True
    try:
        yield trip
    finally:
        c._inside = False


def _record(name: str, x: torch.Tensor) -> None:
    c = _CENSUS
    if c is not None:
        (c.loops[-1][0] if c._inside else c.top).append(
            (name, x.numel() * x.element_size()))


class Mesh:
    """Ranks of the default process group laid out over named axes (the
    counterpart of `jax.sharding.Mesh`): `ranks` in row-major order over
    `axis_names` with sizes `sizes`, `group` the process group over all of
    them (None: the default group, or no process group at all for the
    one-rank mesh of this process), `axis_groups` the group of this rank's
    line along an axis where it is not the whole mesh."""

    def __init__(self, ranks: Sequence[int], axis_names: Sequence[str],
                 sizes: Sequence[int], group=None,
                 axis_groups: Optional[Dict[str, object]] = None):
        self.ranks = tuple(int(r) for r in ranks)
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(n) for n in sizes)
        self.group = group
        self.axis_groups = dict(axis_groups or {})

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.ranks)

    def axis_group(self, axis: str):
        """The group of this rank's line along `axis`."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        return self.axis_groups.get(axis, self.group)

    def coords(self) -> Dict[str, int]:
        """This rank's position along each axis."""
        i = self.ranks.index(dist.get_rank() if dist.is_initialized() else 0)
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            i, out[name] = divmod(i, n)
        return {name: out[name] for name in self.axis_names}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={list(self.ranks)})"


def _group(group):
    return group.group if isinstance(group, Mesh) else group


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_rank0() -> bool:
    """True on rank 0 of the default process group, or without one: the
    rank that writes files in a decomposed run."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp") -> Mesh:
    """1-D mesh over the first `n_devices` ranks of the default process
    group (default: all). Without a process group, the one-rank mesh of
    this process. Every rank of the default group calls it alike (a mesh
    over fewer ranks creates a process group)."""
    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(
            f"mesh needs {n} devices; backend has {world} (one rank per device: "
            f"torchrun --nproc-per-node {n})")
    group = None if n == world else dist.new_group(list(range(n)))
    return Mesh(range(n), (axis_name,), (n,), group)


def ring_perms(n_dev: int):
    """(fwd, bwd) pair lists of the 1-D ring over `n_dev` ranks, as the JAX
    package's `lax.ppermute` takes them: fwd sends rank i's payload to rank
    i + 1 (a rank receives its lower neighbour's rows), bwd the reverse.
    `ring_exchange` follows them, without the pairs that wrap around."""
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _ring_peers(n_dev: int):
    """Per rank, (lower peer, upper peer) of `ring_perms` without the pairs
    that wrap around (None there)."""
    fwd, bwd = ring_perms(n_dev)
    return tuple((b if b == i - 1 else None, f if f == i + 1 else None)
                 for i, ((_, f), (_, b)) in enumerate(zip(fwd, bwd)))


class Sharding:
    """Which block of a leading axis a rank holds: split over the mesh axis
    `axis_name` into equal contiguous blocks, or whole on every rank
    (`axis_name` None: `replicated`)."""

    def __init__(self, mesh: Mesh, axis_name: Optional[str]):
        if axis_name is not None and axis_name not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {axis_name!r}")
        self.mesh, self.axis_name = mesh, axis_name

    def blocks(self, n: int) -> List[slice]:
        """The rows of a leading axis of `n` at each position along the
        axis; raises when the blocks would not be equal, as a
        `NamedSharding` refuses such a shape."""
        if self.axis_name is None:
            return [slice(0, n)]
        k = self.mesh.shape[self.axis_name]
        if n % k != 0:
            raise ValueError(
                f"a leading axis of {n} does not divide over the {k} ranks of mesh "
                f"axis {self.axis_name!r}")
        return [slice(i * (n // k), (i + 1) * (n // k)) for i in range(k)]

    def block(self, n: int) -> slice:
        """This rank's rows of a leading axis of `n`."""
        parts = self.blocks(n)
        return parts[0] if self.axis_name is None else parts[self.mesh.coords()[self.axis_name]]


def batch_sharding(mesh: Mesh, axis_name: str = "dp") -> Sharding:
    """Shard the leading (batch / case) axis over the mesh axis."""
    return Sharding(mesh, axis_name)


def replicated(mesh: Mesh) -> Sharding:
    """The whole leading axis on every rank of the mesh."""
    return Sharding(mesh, None)


def grid_sharding(mesh: Mesh, axis_name: str = "x") -> Sharding:
    """Shard a padded (nx + 2, ny + 2) solver field along x: (nx + 2) / n
    rows a rank, the domain's ghost rows on the end ranks, so that those
    hold one interior row fewer than the others."""
    return Sharding(mesh, axis_name)


def rank_of(group=None) -> int:
    return dist.get_rank(_group(group)) if dist.is_initialized() else 0


def size_of(group=None) -> int:
    return dist.get_world_size(_group(group)) if dist.is_initialized() else 1


def check_backend(device: torch.device, group=None) -> None:
    """Raise unless the group's backend moves tensors of `device`: gloo
    for the CPU, NCCL for CUDA. Without a process group there is nothing
    to move."""
    if not dist.is_initialized():
        return
    backend = dist.get_backend(_group(group))
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
    group = _group(group)
    rank, n = rank_of(group), size_of(group)
    send_up, send_dn = send_up.contiguous(), send_dn.contiguous()
    from_up = torch.zeros_like(send_up)
    from_dn = torch.zeros_like(send_dn)
    dn_peer, up_peer = _ring_peers(n)[rank]
    ops = []
    if dn_peer is not None:
        ops.append(dist.P2POp(dist.isend, send_dn, _peer(group, dn_peer), group))
        ops.append(dist.P2POp(dist.irecv, from_up, _peer(group, dn_peer), group))
    if up_peer is not None:
        ops.append(dist.P2POp(dist.isend, send_up, _peer(group, up_peer), group))
        ops.append(dist.P2POp(dist.irecv, from_dn, _peer(group, up_peer), group))
    COUNTS["exchanges"] += 1
    _record("ppermute", send_up)
    _record("ppermute", send_dn)
    if ops:
        COUNTS["p2p"] += len(ops)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_up, from_dn


def _all_reduce(x: torch.Tensor, op, name: str, group) -> torch.Tensor:
    out = x.clone()
    COUNTS["all_reduce"] += 1
    _record(name, x)
    if dist.is_initialized():
        dist.all_reduce(out, op=op, group=_group(group))
    return out


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks (a new tensor; `x` is left as it is)."""
    return _all_reduce(x, dist.ReduceOp.SUM, "psum", group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Maximum over the ranks (a new tensor)."""
    return _all_reduce(x, dist.ReduceOp.MAX, "pmax", group)


def all_gather(x: torch.Tensor, group=None,
               rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The ranks' `x` stacked along rows in rank order (`all_gather` with
    `tiled=True`). `rows`, each rank's row count in rank order, gathers
    bands of unequal heights: each travels padded to the tallest."""
    x = x.contiguous()
    if rows is not None and len(set(rows)) > 1:
        pad = x.new_zeros((max(rows) - x.shape[0],) + tuple(x.shape[1:]))
        whole = all_gather(torch.cat([x, pad]), group)
        n = max(rows)
        return torch.cat([whole[i * n:i * n + r] for i, r in enumerate(rows)])
    COUNTS["all_gather"] += 1
    _record("all_gather", x)
    if not dist.is_initialized():
        return x.clone()
    parts = [torch.empty_like(x) for _ in range(size_of(group))]
    dist.all_gather(parts, x, group=_group(group))
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
