"""Multi-host (multi-process) execution.

The reference is strictly single-process (SURVEY §2 note: no NCCL/MPI/
Gloo/UCX anywhere); this layer is the labeled extension that scales the
same sharded computations across *hosts*: each process owns its local
devices, `jax.distributed` wires the cluster, meshes span the global
device set, and the existing shard_map code (parallel/batch.py,
parallel/spatial.py) runs unchanged — XLA routes the collectives (NCCL
between GPUs, within a host over NVLink and across hosts over the
network).

Tested for real in tests/test_multihost.py: two coordinated CPU
processes (4 virtual devices each) run `mean_ssim_sharded` over a global
8-device mesh and must agree with the single-process result — the same
differential strategy SURVEY §4.8 prescribes, one level up.

On GPU hosts, pass the coordinator address, process count and process
id explicitly (or run under a cluster manager JAX detects, such as
SLURM); nothing else changes.
"""

from typing import Optional, Sequence

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join (or create) a multi-process JAX cluster.

    Pass all three explicitly (GPU hosts, CPU debugging / CI); with no
    arguments JAX detects the cluster where its environment describes
    one (e.g. SLURM). Idempotent: a second call
    in an already-initialized process is a no-op.
    """
    import jax

    try:
        already = jax.distributed.is_initialized()  # public since jax 0.4.x
    except AttributeError:  # very old jax: fall back to the private state
        from jax._src import distributed as _dist

        already = getattr(_dist.global_state, "client", None) is not None
    if already:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(shape: Sequence[int], axis_names: Sequence[str]):
    """A mesh over the *global* device set (all processes' devices).

    Like mesh.make_mesh but across hosts: jax.devices() returns every
    device in the cluster after initialize(). The leading mesh axis
    varies slowest across processes, so a ("data", ...) layout keeps
    each process's batch shard on its own local chips and the global
    psum is the only DCN traffic — the recipe from the scaling playbook.
    """
    import jax

    from .mesh import make_mesh

    n = int(np.prod(tuple(shape)))
    devices = jax.devices()
    if len(devices) < n:
        raise ValueError(f"need {n} devices across all hosts, have {len(devices)}")
    covered = {d.process_index for d in devices[:n]}
    if len(covered) != jax.process_count():
        # A mesh that excludes whole processes leaves them with no
        # addressable shard; distribute_batch there fails with an opaque
        # error — raise the targeted one here instead.
        raise ValueError(
            f"mesh shape {tuple(shape)} covers devices from {len(covered)} "
            f"of {jax.process_count()} processes; every process must own "
            f"part of the mesh (use more mesh devices or fewer processes)"
        )
    # jax.devices() is already the GLOBAL device set after initialize(),
    # so the single-process constructor builds the cross-host mesh too
    # (one copy of the mesh-building code, per review).
    return make_mesh(tuple(shape), tuple(axis_names))


def distribute_batch(local_batch: np.ndarray, mesh, axis: str = "data"):
    """Assemble a global batch-sharded array from each process's local
    shard (the multi-host input path: hosts never materialize the global
    batch). local_batch: (B_local, H, W); returns a global jax.Array of
    shape (B_local * num_processes_on_axis, H, W) sharded over `axis`."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local_batch)
