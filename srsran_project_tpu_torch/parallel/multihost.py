"""Multi-host scale-out: process-group wiring + host-aware meshes.

Port of ``srsran_project_tpu/parallel/multihost.py``.  The reference's
inter-process links are protocol transports (SCTP/eCPRI); its compute
never crosses hosts.  Here the N-host axis is a first-class data-parallel
dimension: each host serves a set of cells (carriers), the global mesh is
(host, dp, tp), collectives inside a node ride NVLink and those across
nodes the network.  Design rules:

- cells/slots shard over ("host", "dp") — no cross-host traffic in the
  steady state (a cell's slot program is host-local);
- cross-host collectives appear only for control aggregation (metrics
  all-reduces, KPM rollups), so network latency never sits on the
  slot-deadline path.

``initialize()`` creates the default process group for real deployments
(one process per rank, as torch runs).  For tests and single-host
development, ``host_mesh()`` also accepts a virtual host count,
partitioning the ranks into "hosts" — the same program, placements and
collectives run either way (the mesh axes are identical).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from . import mesh as mesh_mod


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device_type: str = "cuda") -> None:
    """Process-group bring-up (one call per rank process) at
    ``tcp://coordinator_address`` ("host:port").

    No-op when single-process (num_processes in (None, 1)), as the
    reference's is; a world of one that needs a group (a mesh) calls
    ``mesh.init_world()`` instead."""
    if not num_processes or num_processes == 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize: several processes need coordinator_address and "
                         "process_id")
    mesh_mod.init_world(device_type, rank=process_id, world_size=num_processes,
                        init_method=f"tcp://{coordinator_address}")


def host_mesh(nof_hosts: int | None = None, tp: int = 1, device_type: str = "cuda"):
    """A (host, dp, tp) mesh over every rank of the world.

    Real multi-host: pass nothing — the host axis follows the node
    boundary (world size // ``LOCAL_WORLD_SIZE`` hosts, as torchrun sets
    it; one host when unset).  Virtual (tests): pass nof_hosts to split
    the ranks into that many host groups; same axes."""
    from torch.distributed.device_mesh import init_device_mesh

    n = mesh_mod._world_size()
    if nof_hosts is None:
        nof_hosts = max(1, n // int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    per_host = n // nof_hosts
    if per_host < 1 or per_host * nof_hosts != n or per_host % tp:
        raise ValueError(f"host_mesh: {n} ranks do not split into {nof_hosts} hosts of "
                         f"tp={tp} groups")
    return init_device_mesh(device_type, (nof_hosts, per_host // tp, tp),
                            mesh_dim_names=("host", "dp", "tp"))


def cell_sharding(mesh) -> mesh_mod.NamedSharding:
    """Shard a (cells, ...) batch over (host, dp): each host owns whole
    cells; no cross-host data-plane traffic."""
    return mesh_mod.sharding(mesh, ("host", "dp"))


def cell_port_sharding(mesh) -> mesh_mod.NamedSharding:
    """(cells, ports, ...) arrays: cells over (host, dp), ports over tp."""
    return mesh_mod.sharding(mesh, ("host", "dp"), "tp")


def replicated(mesh) -> mesh_mod.NamedSharding:
    return mesh_mod.sharding(mesh)


def global_batch(mesh, local_batch: torch.Tensor, sharding: mesh_mod.NamedSharding | None = None):
    """The global (cells, ...) DTensor whose blocks are each rank's local
    batch rows (``DTensor.from_local``, by default over ``cell_sharding``):
    each host contributes the cells it received from its own fronthaul,
    and no data moves between ranks."""
    return (sharding or cell_sharding(mesh)).from_local(local_batch)


def metrics_allreduce(mesh):
    """A cross-host metrics rollup: x (this rank's (cells, ...) block of a
    cell-sharded batch, or the DTensor) -> the sum over every (host, dp)
    block, then over the cells with the dimension kept: (1, ...), the same
    on every rank — the KPM/metric aggregation path that IS allowed to
    cross hosts."""
    from torch.distributed.tensor import DTensor

    ax = mesh_mod.axis(mesh, ("host", "dp"))

    def rollup(x):
        local = x.to_local() if isinstance(x, DTensor) else x
        return ax.all_reduce(local).sum(dim=0, keepdim=True)

    return rollup
