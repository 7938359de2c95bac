"""Device meshes and shardings for the RAN slot programs, on
torch.distributed.

Port of ``srsran_project_tpu/parallel/mesh.py``.  The reference
parallelizes with host threads (SURVEY.md §2.7); here the axes are a
``DeviceMesh``:
  dp — data parallel over slots/UEs/cells (batch axis)
  tp — "tensor" parallel over antenna ports/layers
(sp over subcarrier/PRB shards is the sharded carrier's axis).

Ranks, not devices.  JAX has one controller over many devices; torch runs
one process per rank.  A JAX mesh of n devices is n ranks here: the
mesh's row-major rank array takes the place of its device array, rank r
drives one device (``cuda:r`` modulo the host's cards, or the CPU), and
what JAX runs under ``shard_map`` every rank runs on its own block.  A
``psum`` is an ``all_reduce``, a ``ppermute`` a pair of P2P operations and
a gather an ``all_gather``, each on the process group of the mesh axis
(``axis()``; a tuple of axes gets one group over the product of those
dimensions).  A ``NamedSharding`` is the mesh plus DTensor placements,
one per mesh dimension (``sharding()``).

World of one.  No process group exists until the caller makes one, and
nothing here makes one on import: ``init_world()`` is the one explicit
call.  With no arguments it sets up rank 0 of a world of one (a TCP
rendezvous on a free localhost port), on NCCL with the current card, or
on gloo with ``device_type="cpu"``.  Several processes call it with their
rank, the world size and a shared ``init_method`` (or go through
``multihost.initialize``).  ``make_mesh`` raises when no group exists.
End with ``dist.destroy_process_group()``.
"""

from __future__ import annotations

import dataclasses
import socket
import weakref

import numpy as np
import torch
import torch.distributed as dist


def backend_of(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"device_type {device_type!r}: want 'cuda' or 'cpu'")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(device_type: str = "cuda", rank: int = 0, world_size: int = 1,
               init_method: str | None = None) -> None:
    """Create the default process group: NCCL with this rank's card
    (``cuda:rank`` modulo the cards on the host) for ``"cuda"``, gloo for
    ``"cpu"``.  A world of one needs no ``init_method`` (a free localhost
    port); a larger world must pass one, e.g. ``tcp://host:port``."""
    backend = backend_of(device_type)
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_world: a world of more than one rank needs init_method")
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: device_type 'cuda' but no CUDA device")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.mesh.init_world() first")
    return dist.get_world_size()


def device_of(mesh) -> torch.device:
    """The device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(nof_devices: int | None = None, tp: int = 1, device_type: str = "cuda"):
    """A (dp, tp) mesh over every rank of the world (nof_devices, when
    given, must be the world size)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world_size()
    if nof_devices is not None and nof_devices != n:
        raise ValueError(f"make_mesh: {nof_devices} devices, but the world has {n} ranks")
    if n % tp:
        raise ValueError(f"make_mesh: tp={tp} does not divide {n} ranks")
    return init_device_mesh(device_type, (n // tp, tp), mesh_dim_names=("dp", "tp"))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and one DTensor placement per mesh dimension."""

    mesh: object
    placements: tuple

    def from_local(self, local: torch.Tensor):
        """This rank's block as a DTensor of the sharding."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.mesh, self.placements)


def sharding(mesh, *spec) -> NamedSharding:
    """``NamedSharding(mesh, P(*spec))``: spec[i] names the mesh axis (or
    a tuple of axes, major first) that tensor dimension i shards over, or
    None; every other mesh dimension replicates."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * mesh.ndim
    for dim, names in enumerate(spec):
        if names is None:
            continue
        for name in (names,) if isinstance(names, str) else names:
            placements[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return NamedSharding(mesh, tuple(placements))


def batch_sharding(mesh) -> NamedSharding:
    """Shard the leading batch axis over dp, replicate over tp."""
    return sharding(mesh, "dp")


def port_batch_sharding(mesh) -> NamedSharding:
    """(batch, ports, ...) arrays: batch over dp, ports over tp."""
    return sharding(mesh, "dp", "tp")


def replicated(mesh) -> NamedSharding:
    return sharding(mesh)


# ---- mesh axes as process groups ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis (or a product of axes) as seen from this rank: its
    process group, the global ranks along it in axis order, and this
    rank's index on it.  The collectives are those of a ``shard_map``
    body: complex tensors travel as their real view."""

    group: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """psum: the sum of x over the axis (a new tensor)."""
        out = x.clone()
        dist.all_reduce(torch.view_as_real(out) if out.is_complex() else out, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The axis' blocks (each x's shape) joined along dim, in axis
        order: one ``all_gather``."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        if x.is_complex():
            dist.all_gather([torch.view_as_real(p) for p in parts], torch.view_as_real(x),
                            group=self.group)
        else:
            dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)


# Axes resolved per mesh (a tuple of axes creates process groups, which
# every rank must do once and in the same order).
_AXES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def axis(mesh, names) -> Axis:
    """The Axis of mesh dimension ``names``, or of the product of the
    dimensions in a tuple of names (major first, as JAX orders a tuple
    axis): one group per combination of the other dimensions, built from
    the mesh's rank array."""
    key = (names,) if isinstance(names, str) else tuple(names)
    cache = _AXES.setdefault(mesh, {})
    if key in cache:
        return cache[key]
    dims = [mesh.mesh_dim_names.index(n) for n in key]
    others = [d for d in range(mesh.ndim) if d not in dims]
    rows = mesh.mesh.permute(*others, *dims).reshape(-1, int(np.prod([mesh.size(d)
                                                                        for d in dims])))
    me = dist.get_rank()
    row = next(r for r in rows.tolist() if me in r)
    if len(dims) == 1:
        group = mesh.get_group(dims[0])
    else:
        group, _all = dist.new_subgroups_by_enumeration(rows.tolist())
    cache[key] = Axis(group, tuple(row), row.index(me))
    return cache[key]
