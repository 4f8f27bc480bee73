"""Interchangeable simulation engines behind one protocol.

This reproduces the reference's L1 portability seam — the same driver links
against any backend implementing ``init_simulation`` / ``simulate_one_step``
(part1/common.h:24-25; CMake target wiring part1/CMakeLists.txt:30-33).
Here the seam is :class:`ppsim_tpu.engines.base.Engine`; backends:

- ``oracle``  — O(N^2) all-pairs ground truth (reference: part1/reference.cpp)
- ``binned``  — single-chip sort-rebinned gather engine, whole run in one
  jitted ``lax.scan`` (reference: part1/serial.cpp + part1/vecmp.cpp); keeps
  an explicit particle list, so it is the bitwise-parity partner of the oracle
- ``grid``    — dense slab-grid engine (state lives on the bin grid,
  bin-local coordinates, lazy rebinning); XLA ops everywhere
- ``pallas``  — grid engine with the fused Triton force+move kernel on the
  hot path (reference: part3/gpu.cu CUDA kernels); the flagship perf engine
- ``sharded`` — multi-device shard_map strip decomposition over particle
  lists with ppermute halo exchange and explicit emigrant buffers
  (reference: part2/mpi.cpp, closest structural analog)
- ``sharded_grid`` — the flagship multi-device path: the slab-grid step
  kernel per shard, row-strip sharding, ghost-row halo + ghost-row migration
- ``sharded_tile`` — 2-D tile-mesh decomposition (rows x cols, corner-aware
  two-round halo): surface-to-volume comm scaling, XLA-twin ops per tile
- ``binned3d`` — 3D cell-list engine (3x3x3 stencil, rebuild-per-step
  neighbor candidates); the stretch-config dimension (ndim=3, either law)
- ``grid3d`` — 3D dense slab-grid engine ((cap, Y, X, Z) layout): the
  stretch config in the flagship layout
- ``sharded_grid3d`` — multi-device 3D: y-strip decomposition, ppermute
  ghost-slab halo, cross-shard migration through the extended rebin
"""

from ppsim_tpu.engines.base import (
    Engine, RunResult, engine_names, get_engine, register_engine,
)

# Import for registration side effects.
from ppsim_tpu.engines import oracle as _oracle  # noqa: F401
from ppsim_tpu.engines import binned as _binned  # noqa: F401
from ppsim_tpu.engines import sharded as _sharded  # noqa: F401
from ppsim_tpu.engines import grid as _grid  # noqa: F401
from ppsim_tpu.engines import sharded_grid as _sharded_grid  # noqa: F401
from ppsim_tpu.engines import sharded_tile as _sharded_tile  # noqa: F401
from ppsim_tpu.engines import binned3d as _binned3d  # noqa: F401
from ppsim_tpu.engines import grid3d as _grid3d  # noqa: F401
from ppsim_tpu.engines import sharded_grid3d as _sharded_grid3d  # noqa: F401

__all__ = ["Engine", "RunResult", "engine_names", "get_engine", "register_engine"]
