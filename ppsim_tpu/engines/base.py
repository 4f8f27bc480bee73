"""Engine protocol and the common scan-based run driver.

The reference's driver owns the step loop and the save cadence
(part1/main.cpp:124-139): per step it calls ``simulate_one_step`` and saves
when ``step % savefreq == 0`` (i.e. the first frame is the state after one
step). This driver keeps exactly that cadence but compiles the
whole run into nested ``lax.scan``s, so all ``nsteps`` stay on device —
mirroring the CUDA build, where state is device-resident across all steps and
only the save path copies back (part3/main.cu:120-137).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Type

import jax
import jax.numpy as jnp
import numpy as np

from ppsim_tpu.config import SimConfig
from ppsim_tpu.state import ParticleState

__all__ = ["Monitors", "Carry", "RunResult", "Engine", "register_engine",
           "get_engine", "engine_names"]


class Monitors(NamedTuple):
    """Safety counters accumulated across the run (all int32 scalars).

    ``max_bin_count`` — running max bin occupancy; > ``bin_capacity`` means
    particles were dropped from the force stencil (the reference's CUDA engine
    silently corrupts in this case, gpu.cu:109-111 — here it is detected).
    ``migrate_dropped`` — sharded engine: emigrants dropped because a
    fixed-capacity transfer buffer or the per-device slot pool overflowed
    (analog of part2/mpi.cpp:15's fixed recv buffers, which also cannot grow).
    ``max_speed`` — float32 running max particle speed; the grid engine's
    stale-binning cadence is only valid while
    ``rebin_every * max_speed * dt <= grid_slack`` (checked post-run).
    ``deferred`` — grid engine: leavers kept in their old bin for one rebin
    round because the destination had no free slot (loss-free backpressure;
    transiently stale forces for those particles, non-fatal, self-healing).
    """

    max_bin_count: jax.Array
    migrate_dropped: jax.Array
    max_speed: jax.Array
    deferred: jax.Array

    @staticmethod
    def zeros() -> "Monitors":
        # Distinct buffers on purpose: aliased leaves in a donated carry
        # trip XLA's "donate the same buffer twice" check.
        return Monitors(
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.float32),
            jnp.zeros((), jnp.int32),
        )

    def merge(self, other: "Monitors") -> "Monitors":
        return Monitors(
            jnp.maximum(self.max_bin_count, other.max_bin_count),
            self.migrate_dropped + other.migrate_dropped,
            jnp.maximum(self.max_speed, other.max_speed),
            self.deferred + other.deferred,
        )


class Carry(NamedTuple):
    """Default single-device carry: bin-sorted state + particle identity.

    ``pid[i]`` is the original index of the particle currently stored in row
    ``i`` — engines that keep particles sorted by bin (for locality) use it to
    restore id order for saves, like the MPI engine's id-keyed gather
    (part2/mpi.cpp:220-227).
    """

    pos: jax.Array
    vel: jax.Array
    pid: jax.Array
    monitors: Monitors


class RunResult(NamedTuple):
    state: ParticleState  # final state, id order
    frames: Optional[np.ndarray]  # (F, N, 2) saved positions, id order
    monitors: Monitors  # host-side values

    def check(self, config: SimConfig, capacity: Optional[int] = None) -> None:
        """Raise if any safety monitor tripped. ``capacity`` defaults to the
        sort-binned engines' bin_capacity; grid engines pass grid_capacity."""
        cap = config.bin_capacity if capacity is None else capacity
        mx = int(self.monitors.max_bin_count)
        if mx > cap:
            raise RuntimeError(
                f"bin overflow: max occupancy {mx} > capacity {cap}; "
                "rerun with a larger bin capacity"
            )
        dropped = int(self.monitors.migrate_dropped)
        if dropped:
            raise RuntimeError(
                f"{dropped} particles dropped by fixed-capacity transfer "
                "buffers; increase migrate_capacity / shard_slack / evac_capacity"
            )
        max_speed = float(self.monitors.max_speed)
        if max_speed > 0.0:
            drift = config.rebin_every * max_speed * config.dt
            if drift > config.grid_slack:
                raise RuntimeError(
                    f"stale-bin slack violated: rebin_every*max|v|*dt = {drift:.4g} "
                    f"> slack {config.grid_slack:.4g}; lower rebin_every or raise "
                    "grid_bin_scale"
                )


class Engine:
    """Base engine: subclasses implement the carry transforms; the base owns
    the compiled run program (the L4 driver analog)."""

    name: str = "base"
    #: dimensionalities this engine implements (most are 2D; the oracle and
    #: the 3D cell-list engine extend/replace this)
    supported_ndim = (2,)

    def __init__(self, config: SimConfig):
        config.validate()
        if config.ndim not in self.supported_ndim:
            raise ValueError(
                f"engine {self.name!r} supports ndim in {self.supported_ndim}, "
                f"got ndim={config.ndim}; engines for ndim={config.ndim}: "
                f"{', '.join(engine_names(config.ndim))}"
            )
        self.config = config
        self._programs: Dict[Any, Any] = {}

    @property
    def capacity(self) -> int:
        """Bin capacity this engine's max_bin_count monitor is bounded by."""
        return self.config.bin_capacity

    def check(self, result: "RunResult") -> None:
        result.check(self.config, capacity=self.capacity)

    def repack_plan(self, nsteps: int):
        """Capacity-phase support for the timed drivers: ``None`` (default),
        or ``(min_steps, max_steps)`` — the harness then attempts a
        slot-capacity drop (``attempt_repack``/``commit_repack``) at the
        first program boundary >= min_steps, retrying at later boundaries
        while steps_done <= max_steps. Consult AFTER init_carry (the
        packing measurement). Only Grid3DEngine implements the hooks."""
        return None

    def maybe_escalate_after_drop(self, result: "RunResult") -> bool:
        """Self-healing hook: engines that can grow their slot capacity
        after a dropped-particle run override this to raise capacity and
        return True (caller re-runs from the initial state). Default: the
        drop surfaces through check() as before (Grid3DEngine overrides)."""
        return False

    # ---- backend interface -------------------------------------------------
    def init_carry(self, state: ParticleState):
        n = state.num_parts
        return Carry(state.pos, state.vel, jnp.arange(n, dtype=jnp.int32), Monitors.zeros())

    def step_carry(self, carry):
        raise NotImplementedError

    def frame_of(self, carry):
        """(N, 2) positions in original id order."""
        out = jnp.zeros_like(carry.pos)
        return out.at[carry.pid].set(carry.pos)

    def final_state(self, carry) -> ParticleState:
        pos = jnp.zeros_like(carry.pos).at[carry.pid].set(carry.pos)
        vel = jnp.zeros_like(carry.vel).at[carry.pid].set(carry.vel)
        return ParticleState(pos, vel)

    def monitors_of(self, carry) -> Monitors:
        return carry.monitors

    # ---- common driver -----------------------------------------------------
    def _jit_key(self) -> tuple:
        """Extra program-cache key component for engines whose traced
        closures depend on MUTABLE static geometry (Grid3DEngine's capacity
        phases: the same (nsteps, savefreq) program differs per slot
        capacity). Default: geometry never changes, one cache entry."""
        return ()

    def final_state_jit(self, carry) -> ParticleState:
        """Jitted final_state (eager op-by-op extraction dispatches one
        program per op; never extract state eagerly on the timed path)."""
        cache = self.__dict__.setdefault("_final_jits", {})
        key = self._jit_key()
        if key not in cache:
            cache[key] = jax.jit(self.final_state)
        return cache[key](carry)

    # Engines whose init_carry materializes FRESH buffers (the slab packers)
    # set this True so the run program donates its input carry — at 16.8M
    # particles in 3D the slab state alone is ~2 GB, and keeping the input
    # alive across the run doubles peak HBM for nothing. Engines whose carry
    # aliases the caller's ParticleState arrays (oracle, binned, sharded)
    # must keep it False: donating would delete the caller's state.
    donate_run_carry: bool = False

    def _program(self, nsteps: int, savefreq: int):
        key = (nsteps, savefreq) + self._jit_key()
        if key not in self._programs:
            self._programs[key] = jax.jit(
                functools.partial(self._run_impl, nsteps=nsteps, savefreq=savefreq),
                donate_argnums=(0,) if self.donate_run_carry else (),
            )
        return self._programs[key]

    # ---- segment programs (host-extracted-frame saved runs) ---------------
    # A "segment" is an UNSAVED slice of the run: `length` steps starting
    # after `phase` steps have already executed (engines with a structural
    # cadence — the grid family's rebin — override `_segment_phase` /
    # `_segment_impl` so the cadence continues seamlessly across segment
    # boundaries). The chunked SAVED driver in harness.timed_run_repeats
    # composes these with a separately-jitted `frame_of` pulled between
    # programs: the compiled step program then has the memory profile of the
    # benchmark (unsaved) program — in-program frame capture (the
    # slab→particles gather + frame stacking) OOMed HBM by ~0.7 GB at
    # n=20.97M, while the unsaved program at the same size runs with
    # headroom. Frames land at the reference cadence (after steps
    # 1, 1+savefreq, ...; part1/main.cpp:127-137), bit-identical to the
    # monolithic saved program.
    def _segment_phase(self, steps_done: int) -> int:
        """Cadence phase key for a segment starting after ``steps_done``
        steps. Base engines fold every cadence into step_carry, so all
        phases compile to the same program."""
        return 0

    def _segment_impl(self, carry, *, length: int, phase: int):
        del phase  # base: step_carry is cadence-free
        carry, _ = jax.lax.scan(
            lambda c, _: (self.step_carry(c), None), carry, None, length=length
        )
        return carry

    def _segment_program(self, length: int, phase: int):
        key = ("segment", length, phase) + self._jit_key()
        if key not in self._programs:
            self._programs[key] = jax.jit(
                functools.partial(self._segment_impl, length=length, phase=phase),
                donate_argnums=(0,) if self.donate_run_carry else (),
            )
        return self._programs[key]

    def _frame_program(self):
        """Jitted frame_of (same rationale as final_state_jit)."""
        cache = self.__dict__.setdefault("_frame_jits", {})
        key = self._jit_key()
        if key not in cache:
            cache[key] = jax.jit(self.frame_of)
        return cache[key]

    @staticmethod
    def saved_segment_schedule(nsteps: int, savefreq: int,
                               max_seg: int = None):
        """``[(length, capture_after), ...]`` covering ``nsteps`` steps,
        with a frame captured after global steps 1, 1+savefreq, ... (the
        reference cadence: step, then save when step % savefreq == 0 —
        part1/main.cpp:127-137); segments are additionally cut at
        ``max_seg`` steps when given (bounded device executions)."""
        if not max_seg:
            max_seg = nsteps
        segs, done = [], 0
        while done < nsteps:
            nxt = 1 if done < 1 else 1 + ((done - 1) // savefreq + 1) * savefreq
            end = min(done + max_seg, nxt if nxt <= nsteps else nsteps)
            segs.append((end - done, end == nxt))
            done = end
        return segs

    def _run_impl(self, carry, *, nsteps: int, savefreq: int):
        def plain(c, _):
            return self.step_carry(c), None

        if savefreq <= 0:
            carry, _ = jax.lax.scan(plain, carry, None, length=nsteps)
            return carry, None

        # Reference cadence (part1/main.cpp:127-137): step, then save when
        # step % savefreq == 0 -> frames after steps 1, 1+savefreq, ...
        n_full = nsteps // savefreq
        rem = nsteps - n_full * savefreq

        def saving_block(c, length):
            c = self.step_carry(c)
            # Materialize the carry before capturing: without the barrier
            # XLA duplicates the position-update chain into the frame
            # consumer with different fusion (FMA vs mul+add), putting
            # in-program frames 1 ulp off the state the run carries
            # forward — and off the host-extracted frames of the chunked
            # saved driver, which must match bit-for-bit.
            c = jax.lax.optimization_barrier(c)
            f = self.frame_of(c)
            c, _ = jax.lax.scan(plain, c, None, length=length - 1)
            return c, f

        def outer(c, _):
            return saving_block(c, savefreq)

        frames = None
        if n_full:
            carry, frames = jax.lax.scan(outer, carry, None, length=n_full)
        if rem:
            carry, extra = saving_block(carry, rem)
            extra = extra[None]
            frames = extra if frames is None else jnp.concatenate([frames, extra])
        return carry, frames

    def _chunk_quantum(self, savefreq: int) -> int:
        """Smallest chunk length that keeps every cadence phase-aligned
        across chunk boundaries (grid engines also fold in the rebin
        cadence)."""
        return savefreq

    def run(self, state: ParticleState, nsteps: Optional[int] = None,
            savefreq: int = 0,
            max_device_frame_bytes: int = 2 << 30) -> RunResult:
        """Run ``nsteps`` (default: config.nsteps); save frames every
        ``savefreq`` steps (0 = never). Blocks until the device finishes.

        Saved runs whose frame stack would exceed ``max_device_frame_bytes``
        on device are automatically CHUNKED: the compiled program covers a
        phase-aligned slice of steps, frames stream to the host between
        slices, and the carry stays device-resident throughout. The
        reference streams every frame straight to disk (part1/main.cpp:
        132-137); accumulating all frames in HBM — the natural lax.scan
        formulation — would OOM a 20M-particle ``-o`` run (100 frames x
        160 MB x ndim).
        """
        nsteps = self.config.nsteps if nsteps is None else nsteps
        carry = self.init_carry(state)

        if savefreq > 0:
            frame_bytes = self.config.num_parts * self.config.ndim * 4
            total_frames = max(1, nsteps // savefreq)
            if total_frames * frame_bytes > max_device_frame_bytes:
                # Segment programs + host-side frame extraction: the
                # compiled programs are UNSAVED (in-program frame capture
                # adds the frame-gather temporaries and the frame stack on
                # top of step-program peak HBM — it OOMed at 2D n=20.97M),
                # and each frame is pulled from the carry between programs
                # at the reference cadence. Same step sequence and frames
                # as the monolithic saved program (tested bit-identical).
                frame_jit = self._frame_program()
                frames_host = []
                done = 0
                pending = None  # pull the previous frame AFTER dispatching
                # the next segment: the device->host transfer then overlaps
                # device execution (see harness._timed_run_segments).
                for length, capture in self.saved_segment_schedule(
                        nsteps, savefreq):
                    carry = self._segment_program(
                        length, self._segment_phase(done))(carry)
                    done += length
                    if pending is not None:
                        frames_host.append(np.asarray(pending))
                        pending = None
                    if capture:
                        pending = frame_jit(carry)
                if pending is not None:
                    frames_host.append(np.asarray(pending))
                final = jax.block_until_ready(self.final_state_jit(carry))
                monitors = jax.tree.map(np.asarray, self.monitors_of(carry))
                return RunResult(final, np.stack(frames_host), monitors)

        carry, frames = self._program(nsteps, savefreq)(carry)
        final = jax.block_until_ready(self.final_state_jit(carry))
        monitors = jax.tree.map(np.asarray, self.monitors_of(carry))
        frames_np = np.asarray(frames) if frames is not None else None
        return RunResult(final, frames_np, monitors)

    def step_state(self, state: ParticleState) -> ParticleState:
        """Single step, state-in/state-out (testing convenience)."""
        return self.final_state(self.step_carry(self.init_carry(state)))


_REGISTRY: Dict[str, Type[Engine]] = {}


def register_engine(cls: Type[Engine]) -> Type[Engine]:
    _REGISTRY[cls.name] = cls
    return cls


def get_engine(name: str, config: SimConfig, **kw) -> Engine:
    """Build engine ``name``; ``kw`` goes to its constructor (e.g.
    ``interpret=True`` for the kernel engines on a CPU)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; have {sorted(_REGISTRY)}") from None
    return cls(config, **kw)


def engine_names(ndim: Optional[int] = None) -> list:
    """Registered engine names in registration order, optionally restricted
    to those supporting ``ndim``. Help text and error messages derive from
    this so they cannot drift from the registry (a recurring round-1/2 bug)."""
    return [
        name
        for name, cls in _REGISTRY.items()
        if ndim is None or ndim in cls.supported_ndim
    ]
