#!/usr/bin/env python
"""Benchmark sweeps mirroring the reference's job scripts (SURVEY.md C23).

- ``--sizes``   : problem-size sweep (part1/job-serial:9-16 1k..128k;
                  part3/benchmark-gpu:8-12 1k..16.384M)
- ``--strong``  : strong scaling at fixed n over device counts
                  (part1/strong-scale:11-20; part2/job-mpi:6-13)
- ``--weak``    : weak scaling at fixed n/device (part1/weak-scale:10-22)

Each run appends a JSONL record (the structured analog of the reference's
stdout summary line, with the platform it ran on) to ``--out``; plot with
bench/plot.py. Timing is best-of-``--repeats`` on one compiled program.

Device-count scaling uses the selected engine (default: the flagship
``sharded_grid``) over the GPUs present, or over a CPU mesh
(``--cpu-mesh N --impl xla``) — the srun-free testing story, whose times
are CPU times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _snap_chunk(chunk, nsteps: int, quantum: int):
    """Snap a requested unsaved chunk length to the nearest valid one (a
    multiple of the engine's rebin cadence that divides nsteps) — the
    cadence depends on geometry auto-tuning, so a fixed --chunk-steps can
    be invalid for one size in a sweep; dying mid-sweep loses the stage."""
    if not chunk or (nsteps % chunk == 0 and chunk % quantum == 0):
        return chunk
    valid = [c for c in range(quantum, nsteps + 1, quantum)
             if nsteps % c == 0]
    if not valid:
        return None
    snapped = max([c for c in valid if c <= chunk], default=valid[0])
    print(f"# chunk_steps={chunk} invalid for cadence {quantum} / "
          f"nsteps={nsteps}; snapped to {snapped}", flush=True)
    return snapped


def run_one(engine_name: str, n: int, steps: int, devices=None, seed: int = 42,
            repeats: int = 1, config_kw=None, impl: str = None,
            chunk_steps: int = None, engine_kw=None):
    import jax

    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.harness import timed_run_healing
    from ppsim_tpu.initlib import init_particles

    config = SimConfig(num_parts=n, **(config_kw or {}))
    state = init_particles(config, seed=seed, method="fast")
    sharded_names = ("sharded", "sharded_grid", "sharded_grid3d",
                     "sharded_tile")
    if devices is not None and engine_name in sharded_names:
        from ppsim_tpu.engines.sharded import ShardedEngine
        from ppsim_tpu.engines.sharded_grid import ShardedGridEngine
        from ppsim_tpu.engines.sharded_grid3d import ShardedGrid3DEngine
        from ppsim_tpu.engines.sharded_tile import ShardedTileEngine

        cls = {
            "sharded": ShardedEngine,
            "sharded_grid": ShardedGridEngine,
            "sharded_grid3d": ShardedGrid3DEngine,
            "sharded_tile": ShardedTileEngine,
        }[engine_name]
        kw = dict(engine_kw or {})
        if engine_name == "sharded_grid":
            kw["impl"] = impl or "pallas"
        engine = cls(config, devices=jax.devices()[:devices], **kw)
    else:
        engine = get_engine(engine_name, config)
    chunk_steps = _snap_chunk(chunk_steps, steps,
                              getattr(engine, "rebin_every", 1))
    # Drop-detected capacity self-heal (harness.timed_run_healing):
    # auto-capacity runs that outgrow their slots re-measure at the
    # escalated capacity instead of dying at check().
    result, times = timed_run_healing(engine, state, steps, 0,
                                      repeats=repeats,
                                      chunk_steps=chunk_steps)
    engine.check(result)
    best = min(times)
    return {
        "engine": engine_name,
        "num_parts": n,
        "nsteps": steps,
        "ndim": config.ndim,
        "force_law": config.force_law,
        "density": config.density,
        "dt": config.dt,
        "num_devices": devices or 1,
        "seconds": best,
        "times": [round(t, 4) for t in times],
        "particle_steps_per_sec": n * steps / best,
        "max_bin_count": int(result.monitors.max_bin_count),
        "deferred": int(result.monitors.deferred),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "capacity": engine.capacity,
        "host_cores": os.cpu_count(),
        "chunk_steps": chunk_steps,
        "config": dict(config_kw or {}),
        "engine_kw": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in (engine_kw or {}).items()},
        "ts": time.time(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default=None,
                    help="engine to sweep (default: pallas for --sizes, "
                         "sharded_grid for --strong/--weak)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--out", default="bench/results.jsonl")
    ap.add_argument("--sizes", type=str, default=None,
                    help="comma list of n, e.g. 1000,4000,...  (default: the "
                         "reference's GPU sweep 1k..16.384M)")
    ap.add_argument("--strong", type=int, default=None, metavar="N",
                    help="strong scaling at n=N over 1,2,4,8 devices")
    ap.add_argument("--weak", type=int, default=None, metavar="N_PER_DEV",
                    help="weak scaling at N_PER_DEV per device over 1,2,4,8")
    ap.add_argument("--devices", type=str, default="1,2,4,8",
                    help="device counts for --strong/--weak")
    ap.add_argument("--cpu-mesh", type=int, default=0)
    ap.add_argument("--impl", default=None,
                    help="sharded_grid impl: pallas (the GPU kernel, the "
                         "default) | xla (what a CPU mesh runs)")
    ap.add_argument("--mesh-shape", default=None, metavar="RxC",
                    help="sharded_tile device mesh, e.g. 4x2 (default: "
                         "near-square factorization of the device count)")
    ap.add_argument("--col-block", type=int, default=None,
                    help="sharded_tile: round col tiles up to a multiple of "
                         "this (default 1)")
    ap.add_argument("--grid-bin-scale", type=float, default=None)
    ap.add_argument("--grid-capacity", type=int, default=None)
    ap.add_argument("--grid-pack-mode", default=None,
                    choices=("sort", "claim"),
                    help="slab pack rank mode (recorded in the row)")
    ap.add_argument("--rebin-every", type=int, default=None)
    ap.add_argument("--grid-rebin-mode", default=None,
                    choices=("dirs9", "axes"),
                    help="2D rebin algorithm (A/B axis)")
    ap.add_argument("--grid-snap-lanes", type=int, default=None,
                    choices=(0, 1),
                    help="2D geometry snap to a multiple of 128 bins (A/B "
                         "axis; see SlabGeometry.for_config)")
    # Stretch-config axes (BASELINE.json configs[4] is ndim=3 + lj): every
    # published row must be regenerable from a committed command line
    # (reference discipline: part3/benchmark-gpu:8-12).
    ap.add_argument("--ndim", type=int, default=2)
    ap.add_argument("--density", type=float, default=None,
                    help="box measure per particle (3D runs want ~7e-6)")
    ap.add_argument("--force-law", default=None, help="repulsive | lj")
    ap.add_argument("--dt", type=float, default=None,
                    help="timestep override (lj runs want <= 1e-4)")
    ap.add_argument("--grid3-bin-scale", type=float, default=None)
    ap.add_argument("--grid3-capacity", type=int, default=None)
    ap.add_argument("--rebin3-every", type=int, default=None)
    ap.add_argument("--chunk-steps", type=int, default=None,
                    help="execute the timed run as nsteps/chunk invocations "
                         "of one compiled chunk program (timing contract "
                         "unchanged — chunks dispatch async)")
    args = ap.parse_args(argv)

    if args.cpu_mesh:
        from ppsim_tpu.testing import force_cpu_devices

        force_cpu_devices(args.cpu_mesh)

    config_kw = {
        k: v
        for k, v in (
            ("grid_bin_scale", args.grid_bin_scale),
            ("grid_capacity", args.grid_capacity),
            ("rebin_every", args.rebin_every),
            ("grid_rebin_mode", args.grid_rebin_mode),
            ("grid_snap_lanes",
             None if args.grid_snap_lanes is None else bool(args.grid_snap_lanes)),
            ("density", args.density),
            ("force_law", args.force_law),
            ("dt", args.dt),
            ("grid3_bin_scale", args.grid3_bin_scale),
            ("grid3_capacity", args.grid3_capacity),
            ("rebin3_every", args.rebin3_every),
            ("grid_pack_mode", args.grid_pack_mode),
        )
        if v is not None
    }
    if args.ndim != 2:
        config_kw["ndim"] = args.ndim
    dev_counts = [int(d) for d in args.devices.split(",")]

    def emit(rec):
        # Append immediately: a later size OOMing must not lose earlier rows.
        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def tile_kw(d: int):
        """sharded_tile constructor knobs; mesh-shape applies to the device
        count it factors (other counts fall back to the default near-square
        factorization so one sweep can cover 1,2,4,8)."""
        if args.engine != "sharded_tile":
            return None
        kw = {}
        if args.col_block is not None:
            kw["col_block"] = args.col_block
        if args.mesh_shape:
            pr, pc = (int(v) for v in args.mesh_shape.lower().split("x"))
            if pr * pc == d:
                kw["mesh_shape"] = (pr, pc)
        return kw

    sharded_default = "sharded_grid3d" if args.ndim == 3 else "sharded_grid"
    if args.strong:
        engine = args.engine or sharded_default
        for d in dev_counts:
            emit(run_one(engine, args.strong, args.steps, devices=d,
                         repeats=args.repeats, config_kw=config_kw,
                         impl=args.impl, chunk_steps=args.chunk_steps,
                         engine_kw=tile_kw(d)))
    elif args.weak:
        engine = args.engine or sharded_default
        for d in dev_counts:
            emit(run_one(engine, args.weak * d, args.steps, devices=d,
                         repeats=args.repeats, config_kw=config_kw,
                         impl=args.impl, chunk_steps=args.chunk_steps,
                         engine_kw=tile_kw(d)))
    else:
        engine = args.engine or ("grid3d" if args.ndim == 3 else "pallas")
        if args.sizes:
            sizes = [int(s) for s in args.sizes.split(",")]
        else:
            # part3/benchmark-gpu sweep: 4x steps from 1k; largest first
            # omitted by default to keep runtime sane.
            sizes = [1000 * 4**k for k in range(6)]
        for n in sizes:
            emit(run_one(engine, n, args.steps, repeats=args.repeats,
                         config_kw=config_kw, chunk_steps=args.chunk_steps))

    return 0


if __name__ == "__main__":
    sys.exit(main())
