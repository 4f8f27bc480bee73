"""3D cell-list engine: the stretch-config dimension, XLA end-to-end.

The reference is strictly 2D; its declared stretch direction (BASELINE.json
configs[4]) is a 3D Lennard-Jones variant with neighbor lists. This engine
generalizes the sort-based cell-list formulation (ops/binning.py — stable
sort by cell id + segmented rank, the lock-free analog of the reference's
bin containers, part1/serial.cpp:76-117) to three dimensions:

- cells of side ``bin_size >= cutoff`` on an (nx, ny, nz) grid;
- the 3x3 neighbor stencil becomes 3x3x3 (27 gathers);
- the capacity-padded slot grid *is* the neighbor list: each particle's
  candidate set is exactly the 27 * capacity slots of its stencil, rebuilt
  every step (a rebuild-per-step Verlet list with cell granularity — the
  static-shape-friendly neighbor-list variant).

Both force laws plug in through physics.accel_vec_fn_for — 3D LJ (the full
stretch config) is just ``SimConfig(ndim=3, force_law="lj")``.

The dense slab-grid 3D formulation is engines/grid3d.py; the
oracle (engines/oracle.py, ndim=3) is this engine's ground truth.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ppsim_tpu.engines.base import Carry, Engine, Monitors, register_engine
from ppsim_tpu.ops.binning import build_grid, sort_by_bin
from ppsim_tpu.physics import accel_vec_fn_for, verlet_step

__all__ = ["Binned3DEngine", "Geometry3D"]


@dataclasses.dataclass(frozen=True)
class Geometry3D:
    """Static 3D cell-grid geometry (hashable; duck-typed for build_grid)."""

    nx: int
    ny: int
    nz: int
    capacity: int
    bin_size: float

    @property
    def num_bins(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def num_slots(self) -> int:
        return (self.num_bins + 1) * self.capacity

    @classmethod
    def cube(cls, config) -> "Geometry3D":
        n = config.bins_per_side
        return cls(nx=n, ny=n, nz=n, capacity=config.bin_capacity,
                   bin_size=config.bin_size)


@register_engine
class Binned3DEngine(Engine):
    # profiling.phase_times' trace-time variant seam (see OracleEngine).
    _phase_disable = None
    name = "binned3d"
    supported_ndim = (3,)

    def __init__(self, config):
        super().__init__(config)
        self.geom = Geometry3D.cube(config)

    def step_carry(self, carry: Carry) -> Carry:
        cfg = self.config
        geom = self.geom
        cap = geom.capacity
        pos, vel, pid = carry.pos, carry.vel, carry.pid

        inv = 1.0 / geom.bin_size
        bx = jnp.clip((pos[:, 0] * inv).astype(jnp.int32), 0, geom.nx - 1)
        by = jnp.clip((pos[:, 1] * inv).astype(jnp.int32), 0, geom.ny - 1)
        bz = jnp.clip((pos[:, 2] * inv).astype(jnp.int32), 0, geom.nz - 1)
        bin_id = (bx * geom.ny + by) * geom.nz + bz

        order, sorted_id, rank = sort_by_bin(bin_id)
        pos = pos[order]
        vel = vel[order]
        pid = pid[order]
        bx, by, bz = bx[order], by[order], bz[order]

        grid = build_grid(pos, sorted_id, rank, geom)

        accel_vec = accel_vec_fn_for(cfg)
        cap_iota = jnp.arange(cap, dtype=jnp.int32)[None, :]
        accel = jnp.zeros_like(pos)
        # profiling.phase_times' trace-time variant seam (see OracleEngine;
        # the class attr comes from the 2D BinnedEngine when subclassed —
        # getattr keeps this standalone).
        off = getattr(self, "_phase_disable", None)
        stencil = () if off in ("force", "force+move") else (-1, 0, 1)
        for dxb in stencil:
            for dyb in (-1, 0, 1):
                for dzb in (-1, 0, 1):
                    nxb, nyb, nzb = bx + dxb, by + dyb, bz + dzb
                    valid = (
                        (nxb >= 0) & (nxb < geom.nx)
                        & (nyb >= 0) & (nyb < geom.ny)
                        & (nzb >= 0) & (nzb < geom.nz)
                    )
                    nb = jnp.where(
                        valid, (nxb * geom.ny + nyb) * geom.nz + nzb,
                        geom.num_bins,  # void bin: BIG everywhere
                    )
                    idx = nb[:, None] * cap + cap_iota  # (N, cap)
                    npos = grid.slot_pos[idx]  # (N, cap, 3)
                    accel = accel + accel_vec(npos - pos[:, None, :]).sum(axis=1)

        if off != "force+move":
            pos, vel = verlet_step(pos, vel, accel, cfg.dt, cfg.size)

        z = jnp.zeros((), jnp.int32)
        monitors = carry.monitors.merge(
            Monitors(grid.max_count, z, jnp.zeros((), jnp.float32), z)
        )
        return Carry(pos, vel, pid, monitors)
