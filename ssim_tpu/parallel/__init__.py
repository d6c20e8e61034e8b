"""Distributed execution over device meshes.

The reference's complete parallelism story is (SURVEY.md §2): SIMD lanes,
plus an injected thread pool running a tile grid with lock-free per-thread
partial sums reduced serially at the end (src/ssim.cpp:902-926,1094-1099;
contract include/rmgr/ssim.h:451-466). On a device, lanes and the tile
grid belong to the kernel and XLA, so the inter-device layer is new,
labeled surface: `jax.sharding` meshes with XLA collectives (NCCL
between GPUs) — the equivalent of a distributed communication backend.

- batch.py   — data parallelism: batches of image pairs sharded over the
               mesh; per-image scores stay sharded; mean score via psum
               (the all-reduce analogue of the serial partial-sum loop).
- spatial.py — one huge image sharded by rows; 5-row blur halos exchanged
               with ppermute (the analogue of the reference's
               overlapping tile margins, src/ssim.cpp:230-239).
- mesh.py    — mesh construction helpers.
- multihost.py — multi-process (multi-host) wiring: jax.distributed
               initialization, global meshes spanning every host's
               devices, and process-local batch distribution, tested
               with two real coordinated processes
               (tests/test_multihost.py).
"""

from .mesh import make_mesh, default_mesh
from .batch import ssim_batch_sharded, mean_ssim_sharded
from .spatial import (
    mean_ssim_spatial,
    ssim_grad_spatial_sharded,
    ssim_spatial_sharded,
)
from . import multihost

__all__ = [
    "make_mesh",
    "default_mesh",
    "ssim_batch_sharded",
    "mean_ssim_sharded",
    "ssim_spatial_sharded",
    "ssim_grad_spatial_sharded",
    "mean_ssim_spatial",
    "multihost",
]
