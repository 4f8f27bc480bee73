"""Per-phase timing and profiler-trace helpers.

The reference instruments phases two ways: vecmp.cpp keeps t1..t4 wall-clock
accumulators for insert/force/move/clear dumped by ``callback()``
(part1/vecmp.cpp:25-32,178-183 — source of the write-up's phase table), and
part3 used nvprof for the CUDA kernel split (write-up §6). The analogs here:

- :func:`phase_times` — measures phase costs by *variant subtraction*:
  compile the step scan with a phase disabled and diff the marginal step
  time. Robust against the async-dispatch pitfalls of timing sub-ops in
  isolation (per-call latency floors dwarf sub-millisecond ops here).
- :func:`trace` — ``jax.profiler`` trace context (TensorBoard format), the
  nvprof analog; also reachable via the CLI's ``--trace``.

All timings end in a real device->host sync through a scalar fetch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ppsim_tpu.state import ParticleState

__all__ = ["phase_times", "trace", "timeit_scan"]


def timeit_scan(step_fn, carry, steps_a: int = 10, steps_b: int = 60, reps: int = 3):
    """Marginal per-step seconds of ``step_fn`` inside a jitted scan.

    Times scans of two lengths and divides the difference, cancelling
    per-call dispatch/transfer overhead.
    """

    def runner(n):
        @jax.jit
        def run(c):
            c, _ = jax.lax.scan(lambda cc, _: (step_fn(cc), None), c, None, length=n)
            return jax.tree.map(
                lambda x: x.ravel()[0].astype(jnp.float32)
                if hasattr(x, "ravel")
                else x,
                c,
            )

        return run

    run_a, run_b = runner(steps_a), runner(steps_b)
    jax.device_get(run_a(carry))
    jax.device_get(run_b(carry))

    def best(run):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.device_get(run(carry))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    return max(best(run_b) - best(run_a), 0.0) / (steps_b - steps_a)


def phase_times(engine, state: ParticleState, steps: int = 50) -> Dict[str, float]:
    """Per-phase seconds/step for a slab-family engine (force/move/rebin).

    Returns {"step": t, "force+move": ~, "rebin": ~, "overhead": ~}; each
    phase cost is the marginal slowdown versus a variant with that phase
    disabled (accel hard-zeroed / rebin cadence pushed past the horizon).
    The vecmp t1..t4 analog (part1/vecmp.cpp:25-32,178-183) for the whole
    slab family: 2D and 3D, single-chip and sharded.

    Variant seams differ by family: the single-chip engines route every
    step through ``move_phase``/``rebin_of``, which are monkeypatched; the
    sharded engines bind their local step functions into shard_map closures
    at construction, so they consult the ``_phase_disable`` flag at trace
    time instead (each variant here jits a fresh scan).
    """
    from ppsim_tpu.engines.grid import GridEngine

    if not isinstance(engine, GridEngine):
        return _particle_phase_times(engine, state, steps)

    carry = engine.init_carry(state)
    t_full = timeit_scan(engine.step_carry, carry, 10, 10 + steps)

    def timed_without(phase: str) -> float:
        if hasattr(engine, "_rebin_step"):  # sharded: trace-time flag seam
            engine._phase_disable = phase
            try:
                return timeit_scan(engine.step_carry, carry, 10, 10 + steps)
            finally:
                engine._phase_disable = None
        if phase == "move":
            real, engine.move_phase = engine.move_phase, lambda slab: (
                slab, jnp.zeros((), jnp.float32))
            try:
                return timeit_scan(engine.step_carry, carry, 10, 10 + steps)
            finally:
                engine.move_phase = real
        from ppsim_tpu.ops.grid_ops import RebinMonitors

        z = jnp.zeros((), jnp.int32)
        real, engine.rebin_of = engine.rebin_of, lambda s: (
            s, RebinMonitors(z, z, z))
        try:
            return timeit_scan(engine.step_carry, carry, 10, 10 + steps)
        finally:
            engine.rebin_of = real

    t_nomove = timed_without("move")
    t_norebin = timed_without("rebin")

    force_move = max(t_full - t_nomove, 0.0)
    rebin = max(t_full - t_norebin, 0.0)
    return {
        "step": t_full,
        "force+move": force_move,
        "rebin": rebin,
        "overhead": max(t_full - force_move - rebin, 0.0),
    }


def _particle_phase_times(engine, state: ParticleState,
                          steps: int = 50) -> Dict[str, float]:
    """Phase split for the particle-list engines (oracle/binned/binned3d/
    sharded): force vs move via the same trace-time ``_phase_disable``
    seam the sharded slab engines use. These engines have no separable
    rebin phase (bins rebuild inside the fused sort step — the vecmp
    strategy, part1/vecmp.cpp:88-123), so the sort/binning cost lands in
    "other" along with scan/dispatch overhead. The "force" variant zeroes
    accelerations but still integrates (so the integrator's cost cancels
    in the subtraction); "force+move" also skips the integrator, isolating
    the move cost without letting XLA dead-code-eliminate the force sweep.
    """
    if not hasattr(engine, "_phase_disable"):
        raise TypeError(
            f"engine {engine.name!r} has no phase seam: phase_times needs "
            "either a slab-family engine or a particle-list engine with "
            "the _phase_disable trace-time flag"
        )

    carry = engine.init_carry(state)
    t_full = timeit_scan(engine.step_carry, carry, 10, 10 + steps)

    def timed_without(phase: str) -> float:
        engine._phase_disable = phase
        try:
            return timeit_scan(engine.step_carry, carry, 10, 10 + steps)
        finally:
            engine._phase_disable = None

    t_noforce = timed_without("force")
    t_neither = timed_without("force+move")

    force = max(t_full - t_noforce, 0.0)
    move = max(t_noforce - t_neither, 0.0)
    return {
        "step": t_full,
        "force": force,
        "move": move,
        "other": max(t_full - force - move, 0.0),
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with TensorBoard)."""
    with jax.profiler.trace(log_dir):
        yield
