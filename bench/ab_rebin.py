#!/usr/bin/env python
"""One-process A/B of the 2D rebin algorithms: dirs9 vs axes.

Variants are timed back-to-back in ONE process on one device. Prints one
JSON line per variant; the winner becomes the config default (and the
loser is removed, per the 3D precedent — the unfactorized 27-direction
rebin was deleted after its recorded ablation loss).

Usage:
    python bench/ab_rebin.py                     # n=20.97M x 1000, best of 3
    python bench/ab_rebin.py -n 4194304 --repeats 5 --out bench/results.jsonl
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
    ap.add_argument("--modes", default="dirs9,axes")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.harness import timed_run_repeats
    from ppsim_tpu.initlib import init_particles

    records = []
    for mode in args.modes.split(","):
        config = SimConfig(num_parts=args.n, grid_rebin_mode=mode)
        state = init_particles(config, seed=42, method="fast")
        engine = get_engine(args.engine, config)
        result, times = timed_run_repeats(
            engine, state, args.steps, 0,
            repeats=args.repeats, chunk_steps=args.chunk_steps,
        )
        engine.check(result)
        best = min(times)
        rec = {
            "ab": "grid_rebin_mode",
            "mode": mode,
            "engine": args.engine,
            "num_parts": args.n,
            "nsteps": args.steps,
            "seconds": best,
            "times": [round(t, 4) for t in times],
            "particle_steps_per_sec": args.n * args.steps / best,
            "max_bin_count": int(result.monitors.max_bin_count),
            "dropped": int(result.monitors.migrate_dropped),
            "deferred": int(result.monitors.deferred),
            "chunk_steps": args.chunk_steps,
            "ts": time.time(),
        }
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    if len(records) == 2:
        a, b = records
        print(f"# {b['mode']} / {a['mode']} speedup: "
              f"{a['seconds'] / b['seconds']:.3f}x", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
