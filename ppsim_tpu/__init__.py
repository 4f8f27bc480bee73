"""ppsim_tpu — a JAX parallel particle simulation framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the CS267-style
``parallel-particle-simulation`` reference (2D short-range-repulsion particle
collision simulation, parallelized serial/OpenMP/MPI/CUDA in the reference).

Layer map (the JAX analog of the reference's architecture):

- :mod:`ppsim_tpu.config`   — physics constants + engine tunables
  (reference: part1/common.h:4-11 compile-time macros).
- :mod:`ppsim_tpu.state`    — SoA particle state pytree
  (reference: ``particle_t`` struct, part1/common.h:14-21).
- :mod:`ppsim_tpu.initlib`  — seeded lattice+shuffle initialization
  (reference: ``init_particles``, part1/main.cpp:31-59).
- :mod:`ppsim_tpu.physics`  — pure force / integrate / wall-reflect functions
  (reference: ``apply_force`` / ``move``, part1/serial.cpp:19-71).
- :mod:`ppsim_tpu.engines`  — interchangeable engines behind one protocol
  (reference: the L1 seam ``init_simulation``/``simulate_one_step``,
  part1/common.h:24-25, with 5 backend .cpp/.cu implementations).
- :mod:`ppsim_tpu.engines.sharded` / :mod:`ppsim_tpu.engines.sharded_grid` —
  shard_map spatial decomposition + ppermute halo exchange
  (reference: part2/mpi.cpp MPI row strips + ghost rows).
- :mod:`ppsim_tpu.ops`      — XLA ops and the Pallas (Triton) step kernel
  for the hot path (reference: part3/gpu.cu CUDA kernels).
- :mod:`ppsim_tpu.io`       — trajectory save format, checkpointing, gather
  (reference: ``save`` part1/main.cpp:15-28, ``gather_for_save``
  part2/mpi.cpp:371-402).
- :mod:`ppsim_tpu.harness`  — CLI driver with the reference's flags and the
  benchmark summary line (reference: part1/main.cpp:95-150).
- :mod:`ppsim_tpu.checker`  — absmin/absavg trajectory correctness checker
  (external course tool in the reference; in-repo here).
"""

from ppsim_tpu.config import SimConfig
from ppsim_tpu.state import ParticleState

__version__ = "0.1.0"

__all__ = ["SimConfig", "ParticleState", "__version__"]
