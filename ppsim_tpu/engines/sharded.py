"""Multi-device spatially-sharded engine: shard_map strips + ppermute halo.

A shard_map rebuild of the reference's MPI engine (part2/mpi.cpp):

- 1-D row-strip domain decomposition over x — rank owns a contiguous slab of
  bin rows (reference: ``get_particle_rank`` part2/mpi.cpp:47-51,
  ``init_simulation`` :258-294). Here: a 1-D ``jax.sharding.Mesh`` axis
  ``"x"``; each device owns ``rows_per_shard`` bin rows.
- +1 ghost bin row of padding on each side (reference: :54-59's +1 row
  offset); ghosts are filled each step by exchanging the boundary rows of the
  freshly built bin grid with both neighbors (reference:
  ``communicate_with_neighbor_proc`` :122-146 via ``MPI_Sendrecv``). Here:
  two ``lax.ppermute`` shifts of fixed-shape grid-row slabs — the
  static-shape replacement for MPI's variable-length messages (the reference
  itself bounds its recv buffers, :15,264-265).
- cross-device particle migration after the move phase (reference:
  ``move_particle_cross_processor`` :230-253): emigrants are packed into
  fixed-capacity buffers by a cumsum scatter, ppermuted one hop, and merged
  into the receiver's free particle slots. Jumps of more than one strip per
  step are impossible at sane velocities (the reference assumes the same,
  write-up p.3); they are clamped to one hop per step and converge over
  subsequent steps instead of corrupting. While in transit across an
  intermediate strip a particle is kept OUT of that strip's bin grid (it
  exerts and feels no force for that step — transiently stale, like the grid
  engines' deferral) and is counted in the non-fatal ``deferred`` monitor.
  Only true losses — transfer-buffer or slot-pool overflow — count into the
  fatal ``migrate_dropped``.
- no explicit barriers: SPMD program order replaces the reference's three
  ``MPI_Barrier``s per step (:308,358,364).
- id-keyed gather for saves (reference: ``gather_for_save`` :371-402) is a
  single scatter-by-pid, sharded in, replicated out.

Every device carries a fixed pool of particle slots (``pid = -1`` marks an
empty slot, position parked at the ``BIG`` sentinel). The per-step stable
sort that assigns bin slots doubles as compaction: empties sort to the void
bin at the end.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ppsim_tpu.config import SimConfig
from ppsim_tpu.engines.base import Engine, Monitors, register_engine
from ppsim_tpu.ops.binning import BIG, GridGeometry, build_grid, segment_ranks
from ppsim_tpu.ops.forces import stencil_accel
from ppsim_tpu.physics import verlet_step
from ppsim_tpu.state import ParticleState

__all__ = ["ShardedEngine", "ShardCarry"]


class ShardCarry(NamedTuple):
    """Global-view carry; leading dim of pos/vel/pid is sharded over "x"."""

    pos: jax.Array  # (P*N_cap, 2)
    vel: jax.Array  # (P*N_cap, 2)
    pid: jax.Array  # (P*N_cap,) int32, -1 = empty slot
    monitors: Monitors  # replicated scalars


@register_engine
class ShardedEngine(Engine):
    name = "sharded"
    # profiling.phase_times' trace-time variant seam (see _local_step).
    _phase_disable = None

    def __init__(
        self,
        config: SimConfig,
        devices: Optional[Sequence[jax.Device]] = None,
    ):
        super().__init__(config)
        devices = list(devices) if devices is not None else jax.devices()
        self.mesh = Mesh(np.array(devices), axis_names=("x",))
        self.P = len(devices)

        R = config.bins_per_side
        C = config.bins_per_side
        self.rows_per_shard = -(-R // self.P)
        self.global_rows = R  # physical rows; padded rows beyond R stay empty
        self.ncols = C
        # Local grid: owned rows + 1 ghost row on each side.
        self.local_geom = GridGeometry(
            nrows=self.rows_per_shard + 2,
            ncols=C,
            capacity=config.bin_capacity,
            bin_size=config.bin_size,
        )
        # Particles occupy only ceil(R / rows_per_shard) strips: with
        # rows_per_shard = ceil(R / P), trailing devices can own zero physical
        # rows, so sizing the pool by num_parts / P undercounts the load on
        # the occupied strips.
        occupied = max(1, -(-self.global_rows // self.rows_per_shard))
        n_cap = int(math.ceil(config.num_parts / occupied * config.shard_slack))
        self.n_cap = max(8, -(-n_cap // 8) * 8)
        mc = config.migrate_capacity
        self.m_cap = int(mc) if mc else max(64, C * config.bin_capacity // 2)
        if 2 * self.m_cap > self.n_cap:
            self.m_cap = self.n_cap // 2

        self._shard_step = jax.shard_map(
            self._local_step,
            mesh=self.mesh,
            in_specs=(P("x", None), P("x", None), P("x"), P(), P(), P()),
            out_specs=(P("x", None), P("x", None), P("x"), P(), P(), P()),
        )

    # ------------------------------------------------------------------ init
    def init_carry(self, state: ParticleState) -> ShardCarry:
        cfg = self.config
        pos = np.asarray(state.pos)
        vel = np.asarray(state.vel)
        n = pos.shape[0]

        r_g = np.clip((pos[:, 0] / cfg.bin_size).astype(np.int64), 0, self.global_rows - 1)
        owner = np.clip(r_g // self.rows_per_shard, 0, self.P - 1)

        pos_l = np.full((self.P, self.n_cap, 2), BIG, dtype=pos.dtype)
        vel_l = np.zeros((self.P, self.n_cap, 2), dtype=vel.dtype)
        pid_l = np.full((self.P, self.n_cap), -1, dtype=np.int32)
        for d in range(self.P):
            idx = np.nonzero(owner == d)[0]
            if idx.shape[0] > self.n_cap:
                raise RuntimeError(
                    f"strip {d} holds {idx.shape[0]} particles > slot pool "
                    f"{self.n_cap}; raise shard_slack"
                )
            pos_l[d, : idx.shape[0]] = pos[idx]
            vel_l[d, : idx.shape[0]] = vel[idx]
            pid_l[d, : idx.shape[0]] = idx

        sh2 = NamedSharding(self.mesh, P("x", None))
        sh1 = NamedSharding(self.mesh, P("x"))
        return ShardCarry(
            jax.device_put(pos_l.reshape(-1, 2), sh2),
            jax.device_put(vel_l.reshape(-1, 2), sh2),
            jax.device_put(pid_l.reshape(-1), sh1),
            Monitors.zeros(),
        )

    # ------------------------------------------------------- per-shard step
    def _shift_from_below(self, x, fill):
        """Each device receives from device d+1 (data moves toward -x)."""
        perm = [(i + 1, i) for i in range(self.P - 1)]
        out = jax.lax.ppermute(x, "x", perm)
        is_edge = jax.lax.axis_index("x") == self.P - 1
        return jnp.where(is_edge, fill, out)

    def _shift_from_above(self, x, fill):
        """Each device receives from device d-1 (data moves toward +x)."""
        perm = [(i, i + 1) for i in range(self.P - 1)]
        out = jax.lax.ppermute(x, "x", perm)
        is_edge = jax.lax.axis_index("x") == 0
        return jnp.where(is_edge, fill, out)

    def _local_step(self, pos, vel, pid, max_bin, dropped, deferred):
        cfg = self.config
        geom = self.local_geom
        C = self.ncols
        cap = geom.capacity
        Rl = self.rows_per_shard
        d = jax.lax.axis_index("x")
        row0 = d * Rl

        alive = pid >= 0
        inv = 1.0 / cfg.bin_size
        r_g = jnp.clip((pos[:, 0] * inv).astype(jnp.int32), 0, self.global_rows - 1)
        col = jnp.clip((pos[:, 1] * inv).astype(jnp.int32), 0, C - 1)
        r_loc = r_g - row0  # owned particles have 0 <= r_loc < Rl
        in_strip = alive & (r_loc >= 0) & (r_loc < Rl)
        lrow = jnp.where(in_strip, r_loc + 1, -1000)  # +1 ghost offset
        # Out-of-strip slots (empties AND alive mid-transit far movers) go to
        # the synthetic bin PAST the void bin: build_grid maps its slots out
        # of range, so their real positions never reach the grid. Scattering
        # them into the void bin instead would plant phantom neighbors where
        # the stencil's out-of-bounds redirect expects the BIG sentinel.
        transit = geom.num_bins + 1
        bin_id = jnp.where(in_strip, lrow * C + col, transit)

        # Sort by bin: contiguity for the grid scatter AND compaction of
        # empties (void sorts last).
        order = jnp.argsort(bin_id, stable=True)
        bin_id = bin_id[order]
        pos = pos[order]
        vel = vel[order]
        pid = pid[order]
        lrow = lrow[order]
        col = col[order]
        alive = pid >= 0

        rank = segment_ranks(bin_id)
        grid = build_grid(pos, bin_id, rank, geom)

        # --- halo exchange: boundary grid rows -> neighbors' ghost rows ----
        row_slots = C * cap
        slot_pos = grid.slot_pos
        first_owned = jax.lax.dynamic_slice_in_dim(slot_pos, 1 * row_slots, row_slots)
        last_owned = jax.lax.dynamic_slice_in_dim(slot_pos, Rl * row_slots, row_slots)
        big_fill = jnp.full_like(first_owned, BIG)
        ghost_top = self._shift_from_above(last_owned, big_fill)  # from d-1
        ghost_bot = self._shift_from_below(first_owned, big_fill)  # from d+1
        slot_pos = jax.lax.dynamic_update_slice_in_dim(slot_pos, ghost_top, 0, axis=0)
        slot_pos = jax.lax.dynamic_update_slice_in_dim(
            slot_pos, ghost_bot, (Rl + 1) * row_slots, axis=0
        )

        # --- forces + move -------------------------------------------------
        # profiling.phase_times' trace-time variant seam: the local step is
        # bound into a shard_map closure at construction, so the flag is
        # consulted at trace time (each phase_times variant jits a fresh
        # scan). "force" zeroes accelerations; "force+move" also skips the
        # integrator — the migration machinery below still runs either way.
        off = getattr(self, "_phase_disable", None)
        if off in ("force", "force+move"):
            accel = jnp.zeros_like(pos)
        else:
            accel = stencil_accel(
                pos, lrow, col, slot_pos, geom, cfg.cutoff, cfg.min_r, cfg.mass
            )
        if off != "force+move":
            moved_pos, moved_vel = verlet_step(pos, vel, accel, cfg.dt, cfg.size)
            pos = jnp.where(alive[:, None], moved_pos, pos)
            vel = jnp.where(alive[:, None], moved_vel, vel)

        # --- migration -----------------------------------------------------
        r_g2 = jnp.clip((pos[:, 0] * inv).astype(jnp.int32), 0, self.global_rows - 1)
        owner2 = jnp.clip(r_g2 // Rl, 0, self.P - 1)
        delta = owner2 - d
        far = alive & (jnp.abs(delta) > 1)
        go_up = alive & (delta < 0)
        go_down = alive & (delta > 0)

        def pack(mask):
            slot = jnp.cumsum(mask.astype(jnp.int32)) - 1
            tgt = jnp.where(mask & (slot < self.m_cap), slot, self.m_cap)
            bpos = jnp.full((self.m_cap, 2), BIG, pos.dtype).at[tgt].set(pos, mode="drop")
            bvel = jnp.zeros((self.m_cap, 2), vel.dtype).at[tgt].set(vel, mode="drop")
            bpid = jnp.full((self.m_cap,), -1, jnp.int32).at[tgt].set(pid, mode="drop")
            n_over = jnp.maximum(mask.sum() - self.m_cap, 0)
            return bpos, bvel, bpid, n_over

        up_pos, up_vel, up_pid, over_up = pack(go_up)
        dn_pos, dn_vel, dn_pid, over_dn = pack(go_down)

        # Remove emigrants locally.
        left = go_up | go_down
        pid = jnp.where(left, -1, pid)
        pos = jnp.where(left[:, None], BIG, pos)
        vel = jnp.where(left[:, None], 0.0, vel)

        # One-hop exchange (up buffer travels to d-1, down buffer to d+1).
        in_pid_b = self._shift_from_below(up_pid, jnp.full_like(up_pid, -1))
        in_pos_b = self._shift_from_below(up_pos, jnp.full_like(up_pos, BIG))
        in_vel_b = self._shift_from_below(up_vel, jnp.zeros_like(up_vel))
        in_pid_a = self._shift_from_above(dn_pid, jnp.full_like(dn_pid, -1))
        in_pos_a = self._shift_from_above(dn_pos, jnp.full_like(dn_pos, BIG))
        in_vel_a = self._shift_from_above(dn_vel, jnp.zeros_like(dn_vel))

        inc_pid = jnp.concatenate([in_pid_b, in_pid_a])
        inc_pos = jnp.concatenate([in_pos_b, in_pos_a])
        inc_vel = jnp.concatenate([in_vel_b, in_vel_a])

        # Compact incoming (valid first), then land them in free slots.
        vorder = jnp.argsort((inc_pid < 0).astype(jnp.int8), stable=True)
        inc_pid = inc_pid[vorder]
        inc_pos = inc_pos[vorder]
        inc_vel = inc_vel[vorder]
        n_in = (inc_pid >= 0).sum()

        is_empty = pid < 0
        eorder = jnp.argsort(jnp.logical_not(is_empty).astype(jnp.int8), stable=True)
        n_empty = is_empty.sum()
        m2 = inc_pid.shape[0]
        tgt = eorder[:m2]
        ok = (inc_pid >= 0) & (jnp.arange(m2) < n_empty)
        tgt = jnp.where(ok, tgt, pid.shape[0])  # drop
        pos = pos.at[tgt].set(inc_pos, mode="drop")
        vel = vel.at[tgt].set(inc_vel, mode="drop")
        pid = pid.at[tgt].set(inc_pid, mode="drop")
        pool_over = jnp.maximum(n_in - n_empty, 0)

        # --- monitors (replicated) ----------------------------------------
        # Far movers (>1 strip) are NOT losses: they hop one strip per step
        # and converge. Count them as deferred (non-fatal, self-healing);
        # only buffer/pool overflow is an actual drop (fatal).
        step_drop = (over_up + over_dn + pool_over).astype(jnp.int32)
        max_bin = jnp.maximum(max_bin, jax.lax.pmax(grid.max_count, "x"))
        dropped = dropped + jax.lax.psum(step_drop, "x")
        deferred = deferred + jax.lax.psum(far.sum().astype(jnp.int32), "x")
        return pos, vel, pid, max_bin, dropped, deferred

    # ----------------------------------------------------------- driver API
    def step_carry(self, carry: ShardCarry) -> ShardCarry:
        pos, vel, pid, max_bin, dropped, deferred = self._shard_step(
            carry.pos, carry.vel, carry.pid,
            carry.monitors.max_bin_count, carry.monitors.migrate_dropped,
            carry.monitors.deferred,
        )
        return ShardCarry(
            pos, vel, pid, Monitors(max_bin, dropped, carry.monitors.max_speed, deferred)
        )

    def _id_scatter(self, pid, values, n):
        # pid == -1 must be dropped, but JAX .at[] wraps negative indices
        # (numpy semantics) — redirect empties to an out-of-bounds slot.
        idx = jnp.where(pid >= 0, pid, n)
        out = jnp.zeros((n,) + values.shape[1:], values.dtype)
        return out.at[idx].set(values, mode="drop")

    def frame_of(self, carry: ShardCarry):
        n = self.config.num_parts
        return self._id_scatter(carry.pid, carry.pos, n)

    def final_state(self, carry: ShardCarry) -> ParticleState:
        n = self.config.num_parts
        return ParticleState(
            self._id_scatter(carry.pid, carry.pos, n),
            self._id_scatter(carry.pid, carry.vel, n),
        )
