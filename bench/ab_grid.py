#!/usr/bin/env python
"""One-process A/B of 2D grid-geometry tunables: bin scale / capacity /
rebin cadence.

The reference documents its own bin-size ablations (part1 PDF p.6 table:
BIN_SIZE 0.01/0.02/0.05; part3 PDF Table 2: 2x bin size costs 1.5x) — this
is the slab-grid analog. Variants are timed back-to-back in ONE process on
one device (no cross-process comparison). Prints one JSON line per variant;
bench/geom_fit.py refits the geometry cost model from its rows.

Variant spec: comma-separated ``scale:cap:rebin`` triples, e.g.
``5:11:8,4:9:8,3:7:8,5:11:12``. If the initial lattice over-packs a
variant's capacity, the script bumps the capacity by the reported overflow
and retries (recorded in the row), so under-guessed caps don't kill the
sweep.

Usage:
    python bench/ab_grid.py -n 4194304 --repeats 3 \
        --variants 5:11:8,4:9:8,3:7:8,6:14:8,5:11:12 \
        --out bench/results.jsonl
"""

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_variant(args, scale: float, cap: int, rebin: int):
    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.harness import timed_run_repeats
    from ppsim_tpu.initlib import init_particles

    bumped = 0
    while True:
        # snap OFF: an A/B variant's scale/cap must mean exactly what the
        # spec says (the snap chooser would second-guess the geometry).
        config = SimConfig(num_parts=args.n, grid_bin_scale=scale,
                           grid_capacity=cap, rebin_every=rebin,
                           grid_snap_lanes=False)
        state = init_particles(config, seed=42, method="fast")
        engine = get_engine(args.engine, config)
        try:
            result, times = timed_run_repeats(
                engine, state, args.steps, 0,
                repeats=args.repeats, chunk_steps=args.chunk_steps)
            break
        except RuntimeError as e:  # initial lattice over-packs this capacity
            m = re.search(r"exceeds grid_capacity \d+ by (\d+)", str(e))
            if not m or bumped >= 8:
                raise
            cap += int(m.group(1))
            bumped += int(m.group(1))
    engine.check(result)
    best = min(times)
    return {
        "ab": "grid_geometry",
        "engine": args.engine,
        "grid_bin_scale": scale,
        "grid_capacity": cap,
        "cap_bumped_by": bumped,
        "rebin_every": rebin,
        "num_parts": args.n,
        "nsteps": args.steps,
        "seconds": best,
        "times": [round(t, 4) for t in times],
        "particle_steps_per_sec": args.n * args.steps / best,
        "max_bin_count": int(result.monitors.max_bin_count),
        "dropped": int(result.monitors.migrate_dropped),
        "deferred": int(result.monitors.deferred),
        "max_speed": float(result.monitors.max_speed),
        "chunk_steps": args.chunk_steps,
        "ts": time.time(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=4_194_304)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--engine", default="pallas")
    ap.add_argument("--chunk-steps", type=int, default=None)
    # Cadence picks keep the stale-drift contract rebin*max|v|*dt <=
    # (bin_side - cutoff)/2 with margin: a first sweep ran scale 4 at
    # cadence 8 and the slack violation fed back into the physics (stale
    # bins miss pairs -> overlaps -> repulsion kicks), spiking max|v| to
    # 4.09 and tripping the post-run check. Budget vmax ~3.3: scale 4 ->
    # 6, scale 3 -> 4; 5:11:10 probes the long-cadence end (slack 0.02).
    ap.add_argument("--variants", default="5:11:8,4:9:6,3:7:4,6:14:8,5:11:10",
                    help="comma-separated scale:cap:rebin triples; the "
                         "first is the current default (the control)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    records = []
    for spec in args.variants.split(","):
        scale_s, cap_s, rebin_s = spec.split(":")
        try:
            rec = run_variant(args, float(scale_s), int(cap_s), int(rebin_s))
        except RuntimeError as e:
            # A variant failing its own correctness gate IS a result (the
            # reference records failed ablations too, part3 PDF Table 2).
            rec = {"ab": "grid_geometry", "engine": args.engine,
                   "grid_bin_scale": float(scale_s),
                   "grid_capacity": int(cap_s), "rebin_every": int(rebin_s),
                   "num_parts": args.n, "nsteps": args.steps,
                   "failed": str(e), "ts": time.time()}
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    ok = [r for r in records if "seconds" in r]
    if ok:
        control = ok[0]["seconds"]
        for r in ok[1:]:
            print(f"# scale={r['grid_bin_scale']} cap={r['grid_capacity']} "
                  f"rebin={r['rebin_every']}: {control / r['seconds']:.3f}x "
                  "vs control", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
