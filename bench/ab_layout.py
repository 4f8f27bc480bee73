#!/usr/bin/env python
"""One-process A/B: slab-plane layout vs the sort/gather compact layout.

The slab layout evaluates (occ/cap)^2 ~ 21% useful slot pairs; a
compact, sorted, gather-based layout evaluates only real candidates. That
layout exists in this repo (ops/binning.py + ops/forces.py, the `binned`
engine: sort-rebinned compact bins, 3x3 stencil via gathers), and a GPU
gathers natively, so the question is open again per device: time both
layouts back-to-back in one process at n=4.2M.

The gather engine re-bins EVERY step (vecmp strategy), so its chunk
quantum is 1; it runs fewer steps (same per-step contract, p-s/s is the
comparable).

Usage:
    python bench/ab_layout.py                     # n=4.2M
    python bench/ab_layout.py -n 1048576 --out bench/results.jsonl
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=4_194_304)
    ap.add_argument("--slab-steps", type=int, default=1000)
    ap.add_argument("--gather-steps", type=int, default=100)
    ap.add_argument("--gather-chunk", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.harness import timed_run_repeats
    from ppsim_tpu.initlib import init_particles

    config = SimConfig(num_parts=args.n)
    state = init_particles(config, seed=42, method="fast")

    records = []
    for name, steps, chunk in (
        ("pallas", args.slab_steps, None),
        ("binned", args.gather_steps, args.gather_chunk),
    ):
        engine = get_engine(name, config)
        result, times = timed_run_repeats(engine, state, steps, 0,
                                          repeats=args.repeats,
                                          chunk_steps=chunk)
        engine.check(result)
        best = min(times)
        rec = {
            "ab": "layout_slab_vs_gather",
            "engine": name,
            "num_parts": args.n,
            "nsteps": steps,
            "seconds": best,
            "times": [round(t, 4) for t in times],
            "particle_steps_per_sec": args.n * steps / best,
            "max_bin_count": int(result.monitors.max_bin_count),
            "dropped": int(result.monitors.migrate_dropped),
            "chunk_steps": chunk,
            "ts": time.time(),
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)

    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    if len(records) == 2:
        r0, r1 = records
        ratio = (r0["particle_steps_per_sec"] / r1["particle_steps_per_sec"])
        print(f"# slab layout is {ratio:.2f}x the gather layout "
              f"(particle-steps/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
