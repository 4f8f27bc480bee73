#!/usr/bin/env python
"""One-process A/B of the rebin cadence at the headline geometry.

Cadences are timed back-to-back in ONE process on one device, so the
comparison needs no cross-process numbers (same discipline as
bench/ab_rebin.py / bench/ab_grid.py). Each record carries the stale-slack drift margin
(cadence * max|v| * dt vs (bin_size - cutoff)/2) so the safety headroom of
the winner is recorded alongside the speed.

Usage:
    python bench/ab_cadence.py                         # 10 vs 11 at 20.97M
    python bench/ab_cadence.py --cadences 8,10,11,12 --out bench/results.jsonl
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=20_971_520)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--engine", default="pallas")
    ap.add_argument("--chunk-steps", type=int, default=None)
    ap.add_argument("--cadences", default="10,11")
    ap.add_argument("--ndim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--density", type=float, default=None)
    ap.add_argument("--force-law", default="repulsive")
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.harness import timed_run_repeats
    from ppsim_tpu.initlib import init_particles

    if args.ndim == 3 and args.engine == "pallas":
        args.engine = "grid3d"  # the 3D family runs XLA ops only

    records = []
    for cad_s in args.cadences.split(","):
        cad = int(cad_s)
        extra = {}
        if args.density is not None:
            extra["density"] = args.density
        if args.dt is not None:
            extra["dt"] = args.dt
        if args.ndim == 3:
            config = SimConfig(num_parts=args.n, ndim=3,
                               force_law=args.force_law,
                               rebin3_every=cad, **extra)
        else:
            config = SimConfig(num_parts=args.n,
                               force_law=args.force_law,
                               rebin_every=cad, **extra)
        state = init_particles(config, seed=42, method="fast")
        engine = get_engine(args.engine, config)
        result, times = timed_run_repeats(
            engine, state, args.steps, 0,
            repeats=args.repeats, chunk_steps=args.chunk_steps,
        )
        monitors_ok = True
        try:
            engine.check(result)
        except RuntimeError as e:
            monitors_ok = False
            print(f"# cadence {cad}: monitor tripped: {e}", flush=True)
        best = min(times)
        drift = cad * float(result.monitors.max_speed) * config.dt
        g = engine.geom
        if args.ndim == 3:
            slack = (min(g.bsx, g.bsy, g.bsz) - config.cutoff) / 2.0
        else:
            slack = (g.bin_size - config.cutoff) / 2.0
        rec = {
            "ab": "rebin_cadence",
            "engine": args.engine,
            "ndim": args.ndim,
            "force_law": args.force_law,
            "rebin_every": cad,
            "num_parts": args.n,
            "nsteps": args.steps,
            "seconds": best,
            "times": [round(t, 4) for t in times],
            "particle_steps_per_sec": args.n * args.steps / best,
            "max_bin_count": int(result.monitors.max_bin_count),
            "dropped": int(result.monitors.migrate_dropped),
            "deferred": int(result.monitors.deferred),
            "max_speed": float(result.monitors.max_speed),
            "drift_margin": drift,
            "slack": slack,
            "monitors_ok": monitors_ok,
            "chunk_steps": args.chunk_steps,
            "ts": time.time(),
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)

    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    if len(records) >= 2:
        base = records[0]["seconds"]
        for r in records[1:]:
            print(f"# cadence {r['rebin_every']}: {base / r['seconds']:.4f}x "
                  f"vs cadence {records[0]['rebin_every']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
