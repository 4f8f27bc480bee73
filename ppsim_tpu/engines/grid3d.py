"""3D dense slab-grid engine: the stretch config in the flagship layout.

``grid3d`` — the 27-plane stencil in XLA ops (any backend).

The 2D slab architecture carries over wholesale (see ops/grid3d_ops.py for
the layout): fields are (capacity, Y, X, Z) with y the blocked/shard axis
(x padded to multiples of 8, z to multiples of 128), and the
statically-scheduled run driver, monitors, and save path are inherited
from the 2D GridEngine unchanged (the rebin cadence is ``rebin3_every``,
or auto-derived from the chosen geometry's tightest-axis slack — see
Geometry3S.cadence). Both force laws
plug in through the same seam; the full stretch config
(BASELINE.json configs[4]) is ``SimConfig(ndim=3, force_law="lj")`` with
``--engine grid3d``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ppsim_tpu.engines.base import Monitors, RunResult, register_engine
from ppsim_tpu.engines.grid import GridCarry, GridEngine
from ppsim_tpu.ops import grid3d_ops
from ppsim_tpu.ops.grid3d_ops import Geometry3S, Slab3State
from ppsim_tpu.state import ParticleState

__all__ = ["Grid3DEngine"]


def _coef_of(config):
    from ppsim_tpu.physics import coef_from_r2, lj_coef_from_r2

    if config.force_law == "lj":
        return functools.partial(
            lj_coef_from_r2, cutoff=config.cutoff, min_r=config.min_r,
            mass=config.mass, epsilon=config.lj_epsilon, sigma=config.lj_sigma,
        )
    return functools.partial(
        coef_from_r2, cutoff=config.cutoff, min_r=config.min_r,
        mass=config.mass,
    )


@register_engine
class Grid3DEngine(GridEngine):
    name = "grid3d"
    supported_ndim = (3,)

    def __init__(self, config):
        super(GridEngine, self).__init__(config)  # skip 2D geom setup
        from ppsim_tpu.engines.grid import require_f32

        require_f32(config)
        self.geom = Geometry3S.for_config(config)

    @property
    def capacity(self) -> int:
        # The geometry may add anisotropy headroom slots on top of
        # config.grid3_capacity (Geometry3S.for_config).
        return self.geom.capacity

    @property
    def rebin_every(self) -> int:
        # Geometry-aware: lane-snapped anisotropic bins have per-axis slack,
        # so the auto cadence comes from the chosen geometry's tightest axis.
        return self.geom.cadence(self.config)

    def check(self, result: RunResult) -> None:
        cfg = self.config
        mx = int(result.monitors.max_bin_count)
        # Gate against the LARGEST capacity any phase of the run used: with
        # the capacity-phase repack the prologue legitimately reaches the
        # packing capacity before the engine drops to the run capacity
        # (occupancy past the post-repack capacity is physically impossible
        # — the rebin defers instead — so this loses no detection).
        cap = max(self.capacity, getattr(self, "_pack_capacity", 0) or 0)
        if mx > cap:
            raise RuntimeError(
                f"bin overflow: max occupancy {mx} > capacity {cap}"
            )
        if int(result.monitors.migrate_dropped):
            raise RuntimeError(
                f"{int(result.monitors.migrate_dropped)} particles dropped"
            )
        drift = self.rebin_every * float(result.monitors.max_speed) * cfg.dt
        g = self.geom
        slack = (min(g.bsx, g.bsy, g.bsz) - cfg.cutoff) / 2.0
        if drift > slack:
            raise RuntimeError(
                f"stale-bin slack violated: {drift:.4g} > {slack:.4g}; "
                "lower rebin_every or raise grid3_bin_scale"
            )

    # ------------------------------------------------------------ phases
    def move_phase(self, slab: Slab3State):
        cfg = self.config
        accel = grid3d_ops.grid3_force_xla(
            slab.xl, slab.yl, slab.zl, self.geom, _coef_of(cfg)
        )
        return grid3d_ops.grid3_move(slab, accel, self.geom, cfg.dt, cfg.size)

    def rebin_of(self, slab):
        return grid3d_ops.grid3_rebin_axes(
            slab, self.geom, self.config.evac_capacity
        )

    # ----------------------------------------------------------- protocol
    def _jit_key(self) -> tuple:
        # Program/final/frame caches are keyed by slot capacity: the engine
        # flips between the PACKING capacity (init_carry's auto-raise) and
        # the chooser's RUN capacity (the repack prologue) within one run,
        # and escalates after drops — each is a distinct static geometry.
        return (self.geom.capacity,)

    def _pack_jit(self):
        cache = self.__dict__.setdefault("_packs", {})
        cap = self.geom.capacity
        if cap not in cache:
            geom = self.geom  # bind NOW: self.geom mutates across phases
            mode = self.config.grid_pack_mode
            cache[cap] = jax.jit(
                lambda p, v: grid3d_ops.slab3_from_particles(p, v, geom, mode)
            )
        return cache[cap]

    # ------------------------------------------------- init spill (r5)
    def _spill_enabled(self) -> bool:
        if self.config.grid3_spill is not None:
            return self.config.grid3_spill
        # Auto: only with auto capacity — hand overrides are ablations
        # that must observe the raise (same contract as the LJ floor).
        return self.config.grid3_capacity is None

    def _spill_depth(self) -> float:
        """Max face distance an init-spilled particle may sit from its
        residence bin: the stale-slack budget minus the worst-case drift
        before the first rebin, under the same _VMAX_TAIL speed bound the
        cadence chooser trusts — so spill excursion + drift <= slack by
        construction, and the post-run check still re-verifies drift
        against the MEASURED max speed."""
        g = self.geom
        slack = (min(g.bsx, g.bsy, g.bsz) - self.config.cutoff) / 2.0
        drift = (self.rebin_every * grid3d_ops._VMAX_TAIL
                 * self.config.grid3_vmax * self.config.dt)
        return max(0.0, slack - drift)

    def _pack_spill_jit(self):
        cache = self.__dict__.setdefault("_packs_spill", {})
        cap = self.geom.capacity
        if cap not in cache:
            geom = self.geom
            depth = self._spill_depth()
            mode = self.config.grid_pack_mode
            cache[cap] = jax.jit(
                lambda p, v: grid3d_ops.slab3_from_particles_spill(
                    p, v, geom, depth, mode)
            )
        return cache[cap]

    # Run-tail headroom on top of the measured initial packing, keyed on
    # the force law: the repulsive law's measured run max never exceeds its
    # initial lattice packing (20.97M: packs 12, runs at 12), while LJ's
    # attractive tail clusters pockets ONE slot past it (20.97M: packs 12,
    # runs to 13) — the max_bin_count monitors of earlier stretch runs.
    # This is what previously forced the hand flags `--grid3-capacity 11`
    # (repulsive) / `12` (LJ) at the stretch scale.
    _TAIL_SLOTS = {"repulsive": 0, "lj": 1}

    # Drop-detected escalation (run() below): a capacity replace only
    # changes the slab's slot extent — every per-capacity program re-traces
    # through the keyed caches (_jit_key), including the sharded engine's
    # shard_map closures (strip extents depend on ys and P, never on
    # capacity).
    _capacity_retry = True
    _DROP_RETRIES = 2
    # Capacity-phase repack support (repack_plan below). The sharded 3D
    # engine opts out: its repack program would run the global pack under
    # plain jit, losing the strip sharding mid-run.
    _repack_ok = True
    # First repack attempt (steps), when config.grid3_prologue_steps is
    # None. The t=0 lattice is a near-Poisson random assignment (hot bin 12
    # at 20.97M) while the repulsive dynamics anti-cluster it toward a
    # sub-Poisson steady state — but the relaxation is SLOWER than the
    # r4 verdict assumed: a step-40 position pack at 20.97M overflowed
    # capacity 12, not just 11 (instantaneous by-position demand >= 13
    # during the velocity transient, absorbed at runtime by the rebin's
    # loss-free deferral — arm-off deferred 15362 over the run). Attempts
    # are discovery-only (failed ones cost nothing in the timed replay), so
    # the window is wide; if demand never fits the target, the run stays at
    # the packing capacity and the A/B records the measured reason.
    _REPACK_MIN_STEPS = 40
    _REPACK_MAX_STEPS = 480

    def _set_capacity(self, new_cap: int) -> None:
        """Flip the geometry to ``new_cap`` slots. Cheap: every compiled
        artifact is cached per capacity (_jit_key), so phase flips within a
        run never re-trace. Candidate-choice costs are not re-scored:
        capacity is a pure headroom axis here (the snap chooser already
        priced the bin SHAPE)."""
        self.geom = dataclasses.replace(self.geom, capacity=new_cap)

    def init_carry(self, state: ParticleState) -> GridCarry:
        from ppsim_tpu.engines.grid import seed_pack_monitors

        if getattr(self, "_pack_capacity", None) is not None:
            # Steady state (every timed repeat): the packing capacity is
            # known exactly from the first call, so pack straight at it with
            # NO device->host sync inside the timed region (the overflow
            # still rides the monitors, belt-and-braces).
            if self.geom.capacity != self._pack_capacity:
                self._set_capacity(self._pack_capacity)
            if getattr(self, "_pack_spill", False):
                slab, overflow, _ = self._pack_spill_jit()(
                    state.pos, state.vel)
            else:
                slab, overflow = self._pack_jit()(state.pos, state.vel)
            return GridCarry(slab, jnp.zeros((), jnp.int32),
                             seed_pack_monitors(overflow, self.capacity))

        # First call (the warmup path in the timed drivers): measure the
        # initial packing, spilling or auto-raising once if the lattice
        # packs past the chooser capacity. The host syncs here happen
        # outside any timer.
        slab, overflow = self._pack_jit()(state.pos, state.vel)
        if int(overflow):
            import sys

            packing = self.capacity + int(overflow)
            if self._spill_enabled() and self._spill_depth() > 0.0:
                # Deferral-style spill: keep the chooser capacity (lane
                # work scales ~capacity²) by parking the overflow one bin
                # over, inside the stale-slack envelope — the same state a
                # mid-run rebin deferral produces. Falls through to the
                # raise when the spill cannot place everything.
                slab2, ovf2, spilled = self._pack_spill_jit()(
                    state.pos, state.vel)
                if int(ovf2) == 0:
                    print(
                        f"grid3d: initial packing {packing} exceeds "
                        f"capacity {self.capacity}; spilled "
                        f"{int(spilled)} boundary particle(s) to adjacent "
                        f"bins (deferral-style, excursion <= "
                        f"{self._spill_depth():.4g}) instead of raising "
                        "capacity", file=sys.stderr)
                    self._pack_spill = True
                    self._pack_capacity = self.geom.capacity
                    return GridCarry(slab2, jnp.zeros((), jnp.int32),
                                     seed_pack_monitors(ovf2, self.capacity))
            # Auto-raise: the initial lattice packing is measured exactly
            # (packing = capacity + overflow), so rebuild the geometry at
            # packing + the law-keyed run-tail margin and re-pack once.
            new_cap = packing + self._TAIL_SLOTS.get(
                self.config.force_law, 1)
            print(
                f"grid3d: initial packing {packing} exceeds capacity "
                f"{self.capacity}; auto-raising capacity to {new_cap} "
                f"(+{new_cap - packing} {self.config.force_law} run-tail "
                "headroom)", file=sys.stderr)
            self._set_capacity(new_cap)
            slab, overflow = self._pack_jit()(state.pos, state.vel)
            assert int(overflow) == 0  # packing was measured exactly
        self._pack_capacity = self.geom.capacity
        return GridCarry(slab, jnp.zeros((), jnp.int32),
                         seed_pack_monitors(overflow, self.capacity))

    # --------------------------------------------- capacity-phase repack
    # The t=0 lattice packing is a transient: at 20.97M 3D repulsive the
    # shuffled lattice packs 12 into one bin while the measured-safe RUN
    # capacity is 11, and pair work scales ~capacity², so a whole-run raise
    # costs every step. The reference's analog is its static MAX_PTS_PER_BIN
    # tuning (part3/gpu.cu:10, Table 2). The timed drivers therefore run a
    # short prologue at the packing capacity and then REPACK the slab down
    # to the chooser capacity once the lattice has dispersed: the repack is
    # storage relocation only (an early rebin: global positions recomputed,
    # re-binned by current position), verified loss-free by its overflow
    # scalar before the switch is committed.
    def repack_plan(self, nsteps: int):
        cfg = self.config
        pack_cap = getattr(self, "_pack_capacity", None)
        if pack_cap is None:
            return None  # init_carry not yet run
        target = self._repack_target()
        enabled = cfg.grid3_repack
        if enabled is None:
            enabled = (self._TAIL_SLOTS.get(cfg.force_law, 1) == 0)
        if (not enabled or not self._repack_ok or target >= pack_cap):
            return None
        K = self.rebin_every
        min_s = cfg.grid3_prologue_steps or self._REPACK_MIN_STEPS
        min_s = -(-min_s // K) * K
        if min_s >= nsteps:
            return None
        max_s = max(min_s, min(nsteps // 2, self._REPACK_MAX_STEPS))
        return (min_s, max_s)

    def _repack_target(self) -> int:
        # The chooser's capacity for this config — re-derived, not cached,
        # so drop-escalation (which must never be repacked away) can bump
        # it by raising _escalated_floor.
        base = Geometry3S.for_config(self.config).capacity
        return max(base, getattr(self, "_escalated_floor", 0))

    def attempt_repack(self, carry: GridCarry):
        """Run the repack from the CURRENT capacity to the run target.

        Returns ``(new_carry, overflow)`` with ``overflow`` already an int:
        0 means ``new_carry`` is at the target capacity and the caller must
        ``commit_repack()``; >0 means the target pack would have dropped
        (the pack scatters by CURRENT position with no deferral, so its
        demand can exceed even the packing capacity while the deferral-
        aware rebin runs clean — measured at 20.97M: a step-40 position
        pack overflowed capacity 12 while the cap-12 run's rebins only
        deferred) and ``new_carry`` is the ORIGINAL carry, untouched — a
        failed attempt is bit-identical to never attempting.

        Two programs, not one: a single fused gather+pack program holds the
        old slab, the new slab, the id-ordered particle lists and the
        sort/scatter temporaries in one arena (PJRT allocates a program's
        outputs+temps at dispatch). Split with a scalar fetch fencing the
        pack's dispatch behind the gather's retirement, the two arenas never
        coexist. The fence is one device->host round trip per attempt — in
        the TIMED region only for the one committing attempt (failed
        boundaries are discovery-only, outside the timer)."""
        n = self.config.num_parts
        gkey = ("repack_gather", self.geom.capacity)
        if gkey not in self._programs:
            from_geom = self.geom

            chk = self.config.grid_pack_mode == "claim"

            def gather(c):
                pos, vel = grid3d_ops.slab3_to_particles(
                    c.slab, from_geom, n, chunked=chk)
                return pos, vel, c.step, c.monitors

            self._programs[gkey] = jax.jit(gather)

        to_cap = self._repack_target()
        pkey = ("repack_pack", to_cap)
        if pkey not in self._programs:
            to_geom = dataclasses.replace(self.geom, capacity=to_cap)

            mode = self.config.grid_pack_mode

            def pack(pos, vel, step, monitors):
                slab, overflow = grid3d_ops.slab3_from_particles(
                    pos, vel, to_geom, mode)
                return GridCarry(slab, step, monitors), overflow

            self._programs[pkey] = jax.jit(pack)

        pos, vel, step, monitors = self._programs[gkey](carry)
        int(step)  # fence: gather arena retired before the pack is enqueued
        cand, ovf = self._programs[pkey](pos, vel, step, monitors)
        ovf = int(ovf)
        if ovf:
            return carry, ovf
        return cand, ovf

    def commit_repack(self) -> None:
        """Flip the engine to the run capacity after a verified repack."""
        self._set_capacity(self._repack_target())

    def maybe_escalate_after_drop(self, result) -> bool:
        """Drop-detected capacity escalation hook (Engine default: False).

        The auto-capacity chooser's LJ floor is calibrated to the measured
        benchmark range (ops/grid3d_ops.py, _LJ_FLOOR_* notes); beyond it
        — unmeasured densities, longer runs, bigger grids — attractive-law
        clustering can still outgrow any static choice, and under-capacity
        shows up as DROPPED particles (the monitors catch what the
        reference's gpu.cu:109-111 silently corrupts). Auto-capacity runs
        self-heal instead of failing at the final check: on a drop, raise
        capacity one slot and tell the caller to re-run from the initial
        state (full restart — a dropped particle is unrecoverable
        mid-run). Hand-set capacities (config.grid3_capacity != None)
        never retry: ablations and overflow tests under-provision on
        purpose. Callers: Engine.run-style drivers and the CLI timing path
        (harness.timed_run), each with its own bounded retry count.
        """
        if (self.config.grid3_capacity is not None
                or not self._capacity_retry
                or int(result.monitors.migrate_dropped) == 0):
            return False
        import sys

        new_cap = self.geom.capacity + 1
        print(
            f"grid3d: run dropped "
            f"{int(result.monitors.migrate_dropped)} particle(s) at "
            f"capacity {self.geom.capacity}; escalating to {new_cap} "
            "and re-running from the initial state", file=sys.stderr)
        # The escalated capacity is a measured RUN demand: raise the repack
        # target so the retry can never repack back down to the capacity
        # that just dropped, and the packing capacity so init_carry packs
        # at least this high.
        self._escalated_floor = new_cap
        if getattr(self, "_pack_capacity", None) is not None:
            self._pack_capacity = max(self._pack_capacity, new_cap)
        self._set_capacity(new_cap)
        return True

    def run(self, state: ParticleState, nsteps=None, savefreq: int = 0,
            **kw):
        """Engine.run plus the drop-detected capacity escalation retry
        (see :meth:`maybe_escalate_after_drop`)."""
        result = super().run(state, nsteps, savefreq, **kw)
        for _try in range(self._DROP_RETRIES):
            if not self.maybe_escalate_after_drop(result):
                break
            result = super().run(state, nsteps, savefreq, **kw)
        return result

    def frame_of(self, carry: GridCarry):
        pos, _ = grid3d_ops.slab3_to_particles(
            carry.slab, self.geom, self.config.num_parts,
            chunked=self.config.grid_pack_mode == "claim",
        )
        return pos

    def final_state(self, carry: GridCarry) -> ParticleState:
        pos, vel = grid3d_ops.slab3_to_particles(
            carry.slab, self.geom, self.config.num_parts,
            chunked=self.config.grid_pack_mode == "claim",
        )
        return ParticleState(pos, vel)
