"""Hot-path ops: binning / force / integration building blocks.

Lock-free replacements for the reference's parallel primitives: the OpenMP
per-bin locks (part1/openmp.cpp:21,170-177), the CUDA ``atomicAdd`` bin insert
(part3/gpu.cu:109), and the CUDA force/move kernels (part3/gpu.cu:115-170).
Everything here is lock-free by construction: rebinning is a stable sort +
scatter, forces are dense masked gathers over a capacity-padded bin grid.
"""

from ppsim_tpu.ops.binning import BinGrid, GridGeometry, bin_ids_of, build_grid
from ppsim_tpu.ops.forces import stencil_accel

__all__ = ["BinGrid", "GridGeometry", "bin_ids_of", "build_grid", "stencil_accel"]
