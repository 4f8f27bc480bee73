"""Multi-device 3D slab-grid engine: y-strip decomposition over a 1-D mesh.

The 3D twin of engines/sharded_grid.py: the (capacity, Y, X, Z) slab fields
shard over y (the blocked axis), each device owns a contiguous y-strip, and
per step one boundary y-slab moves to each neighbor by ``lax.ppermute`` —
the same strip/halo architecture as the reference's MPI rows
(part2/mpi.cpp:258-294) rotated into the 3D layout.

Per shard, the grid3 twin ops run on ghost-slab extensions: the 27-plane
stencil force on a 1-ghost-slab extension, the axis-factorized rebin on a
2-ghost-slab one. The rebin's acceptance predicate at a destination needs
its full 3x3x3 count neighborhood, so both neighbors compute identical
transfer decisions from identical overlapping data — cross-shard migration
with no handshake (see sharded_grid.ShardedGridEngine._local_rebin_xla).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ppsim_tpu.config import SimConfig
from ppsim_tpu.engines.base import Monitors, register_engine
from ppsim_tpu.engines.grid import GridCarry
from ppsim_tpu.engines.grid3d import Grid3DEngine, _coef_of
from ppsim_tpu.ops import grid3d_ops
from ppsim_tpu.ops.binning import BIG
from ppsim_tpu.ops.grid3d_ops import Slab3State
from ppsim_tpu.state import ParticleState

__all__ = ["ShardedGrid3DEngine"]

_FILLS = (BIG, BIG, BIG, 0.0, 0.0, 0.0, -1)


@register_engine
class ShardedGrid3DEngine(Grid3DEngine):
    name = "sharded_grid3d"
    supported_ndim = (3,)
    # Drop-detected capacity escalation IS supported (r4 verdict #6, which
    # flagged the old opt-out): a capacity replace changes only the slab's
    # slot extent — the strip extents (ys_local/ys_pad below) depend on ys
    # and P, never on capacity, and the shard_map closures re-trace against
    # the new shapes through the per-capacity program caches (_jit_key).
    _capacity_retry = True
    # No capacity-phase repack: the repack program runs the global
    # unpack/pack under plain jit, which would lose the strip sharding
    # mid-run (a resharding gather). Multi-chip runs keep the packing
    # capacity for the whole run.
    _repack_ok = False

    def __init__(
        self,
        config: SimConfig,
        devices: Optional[Sequence[jax.Device]] = None,
    ):
        super().__init__(config)
        devices = list(devices) if devices is not None else jax.devices()
        self.mesh = Mesh(np.array(devices), axis_names=("x",))
        self.P = len(devices)
        base = self.geom
        # Strips must be at least as tall as the rebin halo (2 ghost slabs):
        # a 1-slab strip would silently truncate the f[:, -2:] halo slice
        # and the interior [2:-2] slice of the extension would be empty.
        # Extra-tall padding strips on small grids are dead slabs (BIG-fill).
        ys_local = max(2, -(-base.ys // self.P))
        self.ys_local = ys_local
        # Pad only the ARRAY extent; geom.ys stays physical so slab3_dirs'
        # grid-edge clamp cannot rebin a particle at exactly y == size into a
        # padding slab.
        self.geom = dataclasses.replace(base, ys_pad=self.P * ys_local)

        spec = P(None, "x", None, None)
        # check_vma=False: grid3_rebin_axes' scan carries start replicated
        # (zeros) and come back shard-varying.
        self._plain_step = jax.shard_map(
            self._local_plain,
            mesh=self.mesh,
            in_specs=(spec,) * 7,
            out_specs=((spec,) * 6) + (P(),),
            check_vma=False,
        )
        self._rebin_step = jax.shard_map(
            self._local_move_rebin,
            mesh=self.mesh,
            in_specs=(spec,) * 7,
            out_specs=((spec,) * 7) + (P(),) * 4,
            check_vma=False,
        )

    # ------------------------------------------------------------- plumbing
    def _from_above(self, x, fill):
        perm = [(i, i + 1) for i in range(self.P - 1)]
        out = jax.lax.ppermute(x, "x", perm)
        return jnp.where(jax.lax.axis_index("x") == 0, fill, out)

    def _from_below(self, x, fill):
        perm = [(i + 1, i) for i in range(self.P - 1)]
        out = jax.lax.ppermute(x, "x", perm)
        return jnp.where(jax.lax.axis_index("x") == self.P - 1, fill, out)

    def _halo(self, f, fill, halo: int):
        """(top, bot) ghost y-slab blocks from both strip neighbors."""
        top = self._from_above(f[:, -halo:], jnp.full_like(f[:, -halo:], fill))
        bot = self._from_below(f[:, :halo], jnp.full_like(f[:, :halo], fill))
        return top, bot

    def _extend(self, state: Slab3State, halo: int) -> Slab3State:
        fields = []
        for f, fill in zip(state, _FILLS):
            t, b = self._halo(f, fill, halo)
            fields.append(jnp.concatenate([t, f, b], axis=1))
        return Slab3State(*fields)

    # ---------------------------------------------------------- local steps
    # phase_times' trace-time variant seam (see sharded_grid.py).
    _phase_disable = None

    def _local_plain(self, xl, yl, zl, vx, vy, vz, pid):
        if self._phase_disable == "move":
            return xl, yl, zl, vx, vy, vz, jnp.zeros((), jnp.float32)
        return self._local_plain_xla(xl, yl, zl, vx, vy, vz, pid)

    def _local_plain_xla(self, xl, yl, zl, vx, vy, vz, pid):
        cfg = self.config
        y0 = jax.lax.axis_index("x") * self.ys_local
        state = Slab3State(xl, yl, zl, vx, vy, vz, pid)
        ext = self._extend(state, 1)
        ax, ay, az = grid3d_ops.grid3_force_xla(
            ext.xl, ext.yl, ext.zl, self.geom, _coef_of(cfg)
        )
        accel = (ax[:, 1:-1], ay[:, 1:-1], az[:, 1:-1])
        new, max_speed = grid3d_ops.grid3_move(
            state, accel, self.geom, cfg.dt, cfg.size, y0=y0
        )
        max_speed = jax.lax.pmax(max_speed, "x")
        return (new.xl, new.yl, new.zl, new.vx, new.vy, new.vz, max_speed)

    def _local_move_rebin(self, xl, yl, zl, vx, vy, vz, pid):
        cfg = self.config
        nxl, nyl, nzl, nvx, nvy, nvz, max_speed = self._local_plain(
            xl, yl, zl, vx, vy, vz, pid
        )
        state = Slab3State(nxl, nyl, nzl, nvx, nvy, nvz, pid)
        y0 = jax.lax.axis_index("x") * self.ys_local

        if self._phase_disable == "rebin":
            z = jnp.zeros((), jnp.int32)
            return (state.xl, state.yl, state.zl, state.vx, state.vy,
                    state.vz, state.pid, z, z, z, max_speed)

        # Axis-factorized rebin: the x/z passes are strictly within-slab
        # (identical on the ghost overlap by construction); only the final
        # y pass crosses slabs and needs the 2-ghost-slab neighborhood.
        # Both neighbors evaluate the same acceptance predicate from the
        # same overlapping data, so cross-shard transfers need no handshake.
        ext = self._extend(state, 2)
        new_ext, _ = grid3d_ops.grid3_rebin_axes(
            ext, self.geom, cfg.evac_capacity, y0=y0 - 2
        )
        new = Slab3State(*(f[:, 2:-2] for f in new_ext))

        before = jax.lax.psum((state.pid >= 0).astype(jnp.int32).sum(), "x")
        occ_planes = (new.pid >= 0).astype(jnp.int32)
        after = jax.lax.psum(occ_planes.sum(), "x")
        # far must come from the PRE-rebin state: each axis pass clamps to one
        # hop, so a 2-bin drifter looks benign afterwards (2D grid_rebin
        # counts it into the fatal dropped monitor pre-rebin).
        _, _, _, far0, _ = grid3d_ops.slab3_dirs(state, self.geom, y0=y0)
        dy, dx, dz, _, alive2 = grid3d_ops.slab3_dirs(new, self.geom, y0=y0)
        deferred = jax.lax.psum(
            (alive2 & ((dy != 0) | (dx != 0) | (dz != 0))).astype(jnp.int32).sum(),
            "x",
        )
        far_n = jax.lax.psum(far0.astype(jnp.int32).sum(), "x")
        occupancy = jax.lax.pmax(occ_planes.sum(axis=0).max(), "x")
        dropped = (before - after) + far_n
        return (new.xl, new.yl, new.zl, new.vx, new.vy, new.vz, new.pid,
                occupancy.astype(jnp.int32), dropped.astype(jnp.int32),
                deferred.astype(jnp.int32), max_speed)

    # -------------------------------------------------------- engine hooks
    def move_phase(self, slab: Slab3State):
        out = self._plain_step(
            slab.xl, slab.yl, slab.zl, slab.vx, slab.vy, slab.vz, slab.pid
        )
        return Slab3State(*out[:6], slab.pid), out[6]

    def step_with_rebin(self, carry: GridCarry) -> GridCarry:
        s = carry.slab
        out = self._rebin_step(s.xl, s.yl, s.zl, s.vx, s.vy, s.vz, s.pid)
        occ, dropped, deferred, max_speed = out[7:]
        monitors = carry.monitors.merge(
            Monitors(occ, dropped, max_speed, deferred)
        )
        return GridCarry(Slab3State(*out[:7]), carry.step + 1, monitors)

    def rebin_of(self, slab):  # pragma: no cover - superclass cond path
        raise NotImplementedError(
            "sharded_grid3d runs rebins only on the statically-blocked path"
        )

    def step_carry(self, carry: GridCarry) -> GridCarry:
        return jax.lax.cond(
            (carry.step + 1) % self.rebin_every == 0,
            self.step_with_rebin,
            self.step_plain,
            carry,
        )

    def init_carry(self, state: ParticleState) -> GridCarry:
        carry = super().init_carry(state)
        sh = NamedSharding(self.mesh, P(None, "x", None, None))
        slab = Slab3State(*(jax.device_put(f, sh) for f in carry.slab))
        return GridCarry(slab, carry.step, carry.monitors)
