"""Slab-grid engines: the flagship single-chip performance path.

``grid``   — dense slab-grid engine with XLA ops everywhere (runs on any
             backend; the correctness twin of the Pallas engine).
``pallas`` — same engine with the fused Triton force+move kernel on the
             hot path (the part3/gpu.cu analog; NVIDIA GPU only, or the
             Pallas interpreter when asked for with ``interpret=True``).

Step structure (cf. the reference's per-step phases, part1/vecmp.cpp:88-176
and part3/gpu.cu:187-208):

1. force   — 3x3 stencil over slot-slab planes (Pallas kernel / XLA).
2. move    — Verlet + wall reflection, elementwise on the grid.
3. rebin   — every ``rebin_every`` steps, the dense 9-direction shuffle.
   Between rebins binning is *stale*; correct while accumulated drift stays
   under ``(bin_side - cutoff)/2``, which the ``max_speed`` monitor verifies
   post-run. The reference rebins every step because pointer updates are
   cheap on CPU (serial.cpp:63-70); on an accelerator, amortizing the
   shuffle is the idiomatic trade.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ppsim_tpu.engines.base import Engine, Monitors, register_engine
from ppsim_tpu.ops import grid_ops
from ppsim_tpu.ops.grid_ops import SlabGeometry, SlabState
from ppsim_tpu.state import ParticleState

__all__ = ["GridEngine", "PallasGridEngine", "GridCarry"]


def require_f32(config) -> None:
    """The slab families are f32-only; see GridEngine.__init__."""
    if config.dtype != "float32":
        raise ValueError(
            "the slab-grid engine family is float32-only (the slot-slab "
            "layout and its kernel are built on f32 planes); "
            "run --dtype float64 through the gather engines "
            "(oracle / binned / binned3d / sharded)"
        )


class GridCarry(NamedTuple):
    slab: SlabState
    step: jax.Array  # int32 step counter (drives the rebin cadence)
    monitors: Monitors


def seed_pack_monitors(overflow, capacity: int) -> Monitors:
    """Initial-carry monitors carrying the packer's overflow count as a
    TRACED value: ``max_bin_count`` is seeded with ``capacity + overflow``
    (the exact initial packing) whenever overflow > 0, so ``check()`` raises
    "bin overflow" post-run. Deferring the check keeps ``init_carry`` free
    of device->host syncs — an eager ``int(overflow)`` would put a host
    round trip inside the reference timing contract's region."""
    # Distinct zero buffers (like Monitors.zeros): aliased leaves in a
    # donated carry trip XLA's donate-the-same-buffer-twice check.
    seeded = jnp.where(overflow > 0,
                       jnp.int32(capacity) + overflow, 0).astype(jnp.int32)
    return Monitors(seeded, jnp.zeros((), jnp.int32),
                    jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32))


@register_engine
class GridEngine(Engine):
    name = "grid"
    # The whole slab family packs a FRESH slab in init_carry, so the run
    # program donates its input carry (halves peak HBM at 16.8M+ particles;
    # see Engine._program).
    donate_run_carry = True

    def __init__(self, config):
        super().__init__(config)
        require_f32(config)
        self.geom = SlabGeometry.for_config(config)

    @property
    def capacity(self) -> int:
        # The CHOSEN geometry's capacity: with grid_snap_lanes it can differ
        # from config.grid_capacity (it follows the snapped occupancy).
        return self.geom.capacity

    @property
    def rebin_every(self) -> int:
        """Rebin cadence the run driver schedules (3D engines override)."""
        return self.config.rebin_every

    def check(self, result) -> None:
        """Geometry-aware monitors gate: capacity and stale-bin slack come
        from the chosen geometry, which under ``grid_snap_lanes`` differs
        from the config-derived values RunResult.check would use (same
        pattern as Grid3DEngine.check)."""
        cfg = self.config
        mx = int(result.monitors.max_bin_count)
        if mx > self.capacity:
            raise RuntimeError(
                f"bin overflow: max occupancy {mx} > capacity {self.capacity}"
            )
        if int(result.monitors.migrate_dropped):
            raise RuntimeError(
                f"{int(result.monitors.migrate_dropped)} particles dropped; "
                "increase evac_capacity / migrate_capacity"
            )
        drift = self.rebin_every * float(result.monitors.max_speed) * cfg.dt
        slack = (self.geom.bin_size - cfg.cutoff) / 2.0
        if drift > slack:
            raise RuntimeError(
                f"stale-bin slack violated: rebin_every*max|v|*dt = "
                f"{drift:.4g} > slack {slack:.4g}; lower rebin_every or "
                "raise grid_bin_scale"
            )

    def _chunk_quantum(self, savefreq: int) -> int:
        # Chunk boundaries must preserve both the save and rebin phases.
        return math.lcm(savefreq, self.rebin_every)

    def accel_of(self, xl, yl):
        from ppsim_tpu.physics import accel_fn_for

        cfg = self.config
        return grid_ops.grid_force_xla(
            xl, yl, self.geom, cfg.cutoff, cfg.min_r, cfg.mass,
            pair_fn=accel_fn_for(cfg),
        )

    def rebin_of(self, slab):
        fn = (grid_ops.grid_rebin_axes if self.config.grid_rebin_mode == "axes"
              else grid_ops.grid_rebin)
        return fn(slab, self.geom, self.config.evac_capacity)

    def move_phase(self, slab):
        """Force + integrate; returns (new_slab, max_speed)."""
        cfg = self.config
        accel = self.accel_of(slab.xl, slab.yl)
        return grid_ops.grid_move(slab, accel, self.geom, cfg.dt, cfg.size)

    # ------------------------------------------------------------- protocol
    def _jit_key(self) -> tuple:
        # Program/final/frame caches are keyed by slot capacity: the
        # drop-detected escalation below flips it mid-engine-lifetime (the
        # 3D subclass additionally flips between packing and run capacities
        # within one run).
        return (self.geom.capacity,)

    def _set_capacity(self, new_cap: int) -> None:
        """Flip the geometry to ``new_cap`` slots; every compiled artifact
        is cached per capacity (_jit_key), so the flip re-traces cleanly."""
        self.geom = dataclasses.replace(self.geom, capacity=new_cap)

    def _pack_jit(self):
        """Cached (per capacity) jitted packer: a fresh ``jax.jit(lambda)``
        per call would re-trace on every timed repeat, adding phantom
        'init' cost."""
        cache = self.__dict__.setdefault("_packs", {})
        cap = self.geom.capacity
        if cap not in cache:
            geom = self.geom  # bind NOW: self.geom mutates on escalation
            mode = self.config.grid_pack_mode
            cache[cap] = jax.jit(
                lambda p, v: grid_ops.slab_from_particles(p, v, geom, mode)
            )
        return cache[cap]

    # Drop-detected capacity escalation (the 2D analog of the r4 3D
    # machinery): the snap chooser's capacity model is calibrated on the
    # repulsive law's occupancy (packing-dominated); the Lennard-Jones
    # attractive tail grows run occupancy past ANY t=0-derived choice at
    # large bin counts (measured: 44 particles dropped at the 20.97M
    # 2D LJ headline, capacity 14 — r5 queue log), and under-capacity shows
    # up as DROPPED particles. Auto-capacity runs self-heal: raise one slot,
    # re-run from the initial state (callers: Engine.run below and
    # harness.timed_run, each with bounded retries). Hand capacities
    # (config.grid_capacity != None) never retry — ablations and overflow
    # tests under-provision on purpose.
    _capacity_retry = True
    _DROP_RETRIES = 2

    def maybe_escalate_after_drop(self, result) -> bool:
        if (self.config.grid_capacity is not None
                or not self._capacity_retry):
            return False
        dropped = int(result.monitors.migrate_dropped)
        # Pack overflow rides the monitors (seed_pack_monitors): a seeded
        # max_bin_count > capacity means the INITIAL packing overflowed and
        # the packer dropped the excess — escalate straight to the measured
        # packing (the 3D subclass instead auto-raises inside init_carry).
        packing = int(result.monitors.max_bin_count)
        if dropped == 0 and packing <= self.geom.capacity:
            return False
        import sys

        new_cap = max(self.geom.capacity + 1, packing)
        print(
            f"{self.name}: run dropped {dropped} particle(s) / packed "
            f"{packing} at capacity {self.geom.capacity}; escalating to "
            f"{new_cap} and re-running from the initial state",
            file=sys.stderr)
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

    def init_carry(self, state: ParticleState) -> GridCarry:
        slab, overflow = self._pack_jit()(state.pos, state.vel)
        # The pack-overflow check is DEFERRED: seeding max_bin_count with
        # capacity+overflow makes check() raise "bin overflow" post-run
        # instead of an eager `int(overflow)` here, which forced a
        # device->host sync INSIDE the reference's timed region (init_carry
        # is the init_simulation analog, part1/main.cpp:120).
        return GridCarry(slab, jnp.zeros((), jnp.int32),
                         seed_pack_monitors(overflow, self.capacity))

    def step_plain(self, carry: GridCarry) -> GridCarry:
        slab, max_speed = self.move_phase(carry.slab)
        z = jnp.zeros((), jnp.int32)
        monitors = carry.monitors.merge(Monitors(z, z, max_speed, z))
        return GridCarry(slab, carry.step + 1, monitors)

    def step_with_rebin(self, carry: GridCarry) -> GridCarry:
        slab, max_speed = self.move_phase(carry.slab)
        slab, rmon = self.rebin_of(slab)
        monitors = carry.monitors.merge(
            Monitors(rmon.max_occupancy, rmon.dropped, max_speed, rmon.deferred)
        )
        return GridCarry(slab, carry.step + 1, monitors)

    def step_carry(self, carry: GridCarry) -> GridCarry:
        """General single step: rebin under a traced cond. Testing/API
        convenience only — both the benchmark and save paths run through the
        statically-scheduled ``_run_impl`` below, which never branches."""
        cfg = self.config

        slab, max_speed = self.move_phase(carry.slab)

        def do_rebin(s):
            return self.rebin_of(s)

        def no_rebin(s):
            z = jnp.zeros((), jnp.int32)
            return s, grid_ops.RebinMonitors(z, z, z)

        step = carry.step + 1
        slab, rmon = jax.lax.cond(
            step % self.rebin_every == 0, do_rebin, no_rebin, slab
        )

        monitors = carry.monitors.merge(
            Monitors(rmon.max_occupancy, rmon.dropped, max_speed, rmon.deferred)
        )
        return GridCarry(slab, step, monitors)

    def _segment_phase(self, steps_done: int) -> int:
        return steps_done % self.rebin_every

    def _segment_impl(self, carry, *, length: int, phase: int):
        """Unsaved ``length``-step slice starting after ``phase`` global
        steps: rebins land on global steps ≡ 0 (mod rebin_every), so
        segments compose bit-identically with the monolithic schedule
        (phase 0 over the whole run is exactly the unsaved benchmark
        program)."""
        K = self.rebin_every

        def plain_scan(c, n):
            if n <= 0:
                return c
            c, _ = jax.lax.scan(
                lambda cc, _: (self.step_plain(cc), None), c, None, length=n
            )
            return c

        def block(c, _):
            return self.step_with_rebin(plain_scan(c, K - 1)), None

        r = phase % K
        if r:
            first = K - r  # steps to and including the next rebin boundary
            if first > length:
                return plain_scan(carry, length)
            carry = self.step_with_rebin(plain_scan(carry, first - 1))
            length -= first
        nblocks, rem = divmod(length, K)
        if nblocks:
            carry, _ = jax.lax.scan(block, carry, None, length=nblocks)
        return plain_scan(carry, rem)

    def _run_impl(self, carry, *, nsteps: int, savefreq: int):
        """Statically-scheduled run driver: no per-step branch ever, and no
        collectives inside conditionals for the sharded variant.

        Unsaved runs scan [K-1 plain + 1 rebin] blocks. Saved runs scan a
        statically-unrolled period of ``L = lcm(savefreq, K)`` steps in which
        both the rebin cadence (every K-th step) and the save cadence (after
        steps 1, 1+savefreq, ... — the reference's part1/main.cpp:127-137)
        are compile-time positions — so the checked path and the benchmarked
        path run the exact same step code (round-1 verdict: the traced-cond
        fallback was a separate, never-benchmarked program).
        """
        K = self.rebin_every

        if savefreq <= 0:
            return self._segment_impl(carry, length=nsteps, phase=0), None

        L = math.lcm(savefreq, K)
        # The period is statically unrolled: L step bodies in one scan. Near-
        # coprime cadences (e.g. --savefreq 7 with rebin_every 4 -> L = 28)
        # multiply compile time/memory; a 3D rebin program already compiles
        # in ~8 min on a 1-core host. Warn early, refuse the pathological.
        if L > 16 * max(savefreq, K):
            raise ValueError(
                f"savefreq={savefreq} and rebin cadence {K} are near-coprime: "
                f"the saved-run driver would statically unroll lcm={L} step "
                "bodies per scan period. Align savefreq with the rebin "
                "cadence (make one divide the other) or adjust rebin_every."
            )
        if L > 4 * max(savefreq, K):
            import warnings

            warnings.warn(
                f"saved-run driver unrolls lcm(savefreq={savefreq}, "
                f"rebin_every={K}) = {L} step bodies per scan period; expect "
                "a long compile. Aligning the cadences avoids this.",
                stacklevel=2,
            )

        def steps_with_saves(c, length):
            """Unrolled ``length`` steps (phase-0 start): rebin on every K-th,
            frame after steps 1, 1+savefreq, ... Returns (carry, [frames])."""
            frames = []
            for i in range(1, length + 1):
                c = self.step_with_rebin(c) if i % K == 0 else self.step_plain(c)
                if (i - 1) % savefreq == 0:
                    # Barrier before capture: keeps in-program frames
                    # bit-identical to the carried state (and to the
                    # chunked saved driver's host-extracted frames) — see
                    # Engine._run_impl.saving_block.
                    c = jax.lax.optimization_barrier(c)
                    frames.append(self.frame_of(c))
            return c, frames

        n_periods = nsteps // L
        rem = nsteps - n_periods * L
        frames = None
        if n_periods:

            def period(c, _):
                c, fs = steps_with_saves(c, L)
                return c, jnp.stack(fs)

            carry, stacked = jax.lax.scan(period, carry, None, length=n_periods)
            frames = stacked.reshape((-1,) + stacked.shape[2:])
        if rem:
            # Cadence phases continue seamlessly: savefreq and K both divide L.
            carry, fs = steps_with_saves(carry, rem)
            if fs:
                tail = jnp.stack(fs)
                frames = tail if frames is None else jnp.concatenate([frames, tail])
        return carry, frames

    def frame_of(self, carry: GridCarry):
        pos, _ = grid_ops.slab_to_particles(
            carry.slab, self.geom, self.config.num_parts,
            chunked=self.config.grid_pack_mode == "claim",
        )
        return pos

    def final_state(self, carry: GridCarry) -> ParticleState:
        pos, vel = grid_ops.slab_to_particles(
            carry.slab, self.geom, self.config.num_parts,
            chunked=self.config.grid_pack_mode == "claim",
        )
        return ParticleState(pos, vel)

    def monitors_of(self, carry: GridCarry) -> Monitors:
        return carry.monitors


@register_engine
class PallasGridEngine(GridEngine):
    name = "pallas"

    def __init__(self, config, interpret: bool = False):
        from ppsim_tpu.ops.pallas_grid import require_gpu

        super().__init__(config)
        require_gpu(interpret)
        self.interpret = interpret

    def move_phase(self, slab):
        from ppsim_tpu.ops.pallas_grid import grid_step_pallas

        cfg = self.config
        xl, yl, vx, vy, speed2 = grid_step_pallas(
            slab.xl, slab.yl, slab.vx, slab.vy, self.geom,
            cfg.cutoff, cfg.min_r, cfg.mass, cfg.dt, cfg.size,
            interpret=self.interpret,
            law=cfg.force_law, law_params=cfg.law_params,
        )
        # max over the kernel-emitted per-bin |v|^2 plane (order-free, so
        # bit-identical to the XLA twin's reduction over the full slabs)
        max_speed = jnp.sqrt(speed2.max())
        return SlabState(xl, yl, vx, vy, slab.pid), max_speed
