"""Single-chip binned engine: sort-rebin + stencil forces, one jitted scan.

The static-shape unification of the reference's three shared-memory engines:

- rebin-every-step strategy (part1/vecmp.cpp:88-123) rather than incremental
  pointer migration (part1/serial.cpp:63-70) — rebuild-per-step is the only
  static-shape-friendly choice, and the reference's own phase measurements
  show it is competitive (part1 write-up p.10);
- lock-free slot assignment by stable sort + segmented rank, replacing the
  OpenMP per-bin locks (part1/openmp.cpp:21,170-177) and the CUDA
  ``atomicAdd`` (part3/gpu.cu:109);
- the 3x3 stencil force gather (part1/serial.cpp:102-117, part3/gpu.cu:115-142)
  as dense masked vector ops over the capacity-padded grid;
- device-resident state across the whole run, like the CUDA build
  (part3/main.cu:120-137): the base driver compiles all steps into one scan.

Particles are kept *bin-sorted across steps* (identity tracked via
``carry.pid``): since a particle moves at most a fraction of a bin per step,
each step's argsort input is nearly sorted, and the force gathers touch
near-contiguous grid slots.
"""

from __future__ import annotations

import jax.numpy as jnp

from ppsim_tpu.engines.base import Carry, Engine, Monitors, register_engine
from ppsim_tpu.ops.binning import GridGeometry, bin_ids_of, build_grid, sort_by_bin
from ppsim_tpu.ops.forces import stencil_accel
from ppsim_tpu.physics import verlet_step

__all__ = ["BinnedEngine"]


@register_engine
class BinnedEngine(Engine):
    name = "binned"

    # profiling.phase_times' trace-time variant seam (see OracleEngine).
    _phase_disable = None

    def __init__(self, config):
        super().__init__(config)
        self.geom = GridGeometry.square(config)

    def accel_of(self, pos_sorted, row, col, grid):
        """Force phase (the 3x3 stencil gather)."""
        from ppsim_tpu.physics import accel_fn_for

        cfg = self.config
        return stencil_accel(
            pos_sorted, row, col, grid.slot_pos, self.geom,
            cfg.cutoff, cfg.min_r, cfg.mass, pair_fn=accel_fn_for(cfg),
        )

    def step_carry(self, carry: Carry) -> Carry:
        cfg = self.config
        geom = self.geom

        _, _, bin_id = bin_ids_of(carry.pos, geom)
        order, sorted_id, rank = sort_by_bin(bin_id)
        pos = carry.pos[order]
        vel = carry.vel[order]
        pid = carry.pid[order]

        grid = build_grid(pos, sorted_id, rank, geom)
        row = sorted_id // geom.ncols
        col = sorted_id - row * geom.ncols

        off = self._phase_disable
        if off in ("force", "force+move"):
            accel = jnp.zeros_like(pos)
        else:
            accel = self.accel_of(pos, row, col, grid)
        if off != "force+move":
            pos, vel = verlet_step(pos, vel, accel, cfg.dt, cfg.size)

        z = jnp.zeros((), jnp.int32)
        monitors = carry.monitors.merge(
            Monitors(grid.max_count, z, jnp.zeros((), jnp.float32), z)
        )
        return Carry(pos, vel, pid, monitors)
