#!/usr/bin/env python
"""Small-n dispatch floor: measure it, attribute it, amortize it away.

Below ~64k particles a run is launch-bound: the reference P100 takes
48-71 ms per 1000 steps there (BASELINE.md), and a few host round trips
per run can dominate the compute. This script answers what that floor IS
and what the device can do without it:

1. **floor**: the bare per-execution latency — one trivial compiled
   program + scalar fetch, timed hot. A standard timed run pays a few
   such round trips (the pack, the run dispatch, the final scalar probe).
2. **fused single run**: ONE complete run — slab packing + all nsteps +
   the final-state scalar — compiled into ONE program, so a
   standard-contract run pays exactly ONE round trip (the same program
   boundary the reference's AOT binary has).
3. **amortized per-run time**: K complete runs (the full reference timing
   contract per run) compiled into ONE program, chained by an exact-zero
   data dependence so XLA cannot overlap or elide them; per-run =
   total / K — the reference's own binary pays one process launch, not
   one per run.
4. the standard `timed_run_repeats` number in the SAME process, so the
   floor attribution needs no cross-process comparison.

Every row records the platform and device it ran on.

Usage:
    python bench/smalln.py                          # 1k/4k/16k/64k, K=8
    python bench/smalln.py --sizes 1000 --k 16 --out bench/results.jsonl
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure_floor(reps: int = 20) -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np

    trivial = jax.jit(lambda x: x * 2.0)
    x = jnp.ones((8, 128), jnp.float32)
    np.asarray(trivial(x)[0, 0])  # compile + warm the fetch path
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(trivial(x)[0, 0])
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1000,4000,16000,64000")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--k", type=int, default=8, help="runs fused per program")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.engines.base import Monitors
    from ppsim_tpu.engines.grid import GridCarry
    from ppsim_tpu.harness import timed_run_repeats
    from ppsim_tpu.initlib import init_particles
    from ppsim_tpu.ops import grid_ops

    floor = measure_floor()
    print(json.dumps({"ab": "small_n_floor", "per_exec_seconds": floor,
                      "ts": time.time()}), flush=True)

    # P100 rows at matched sizes (part3 PDF Table 1 / benchmark-gpu:8-12)
    p100 = {1000: 0.0482, 4000: 0.0507, 16000: 0.0710, 64000: 0.1999}

    records = []
    for n in (int(s) for s in args.sizes.split(",")):
        config = SimConfig(num_parts=n)
        state = init_particles(config, seed=42, method="fast")
        engine = get_engine("pallas", config)

        # -- standard contract, same session (3 round trips per run) ------
        result, times = timed_run_repeats(engine, state, args.steps, 0,
                                          repeats=args.repeats)
        engine.check(result)
        std_best = min(times)

        # -- K runs in one program (full per-run contract: pack + steps) --
        pos = jax.device_put(jnp.asarray(state.pos))
        vel = jax.device_put(jnp.asarray(state.vel))
        K, nsteps = args.k, args.steps

        # -- ONE complete run in one program: the standard contract at one
        # round trip (pack + steps + final scalar fused) -------------------
        @jax.jit
        def one_run(pos, vel):
            slab, overflow = grid_ops.slab_from_particles(
                pos, vel, engine.geom)
            carry = GridCarry(slab, jnp.zeros((), jnp.int32),
                              Monitors.zeros())
            carry = engine._segment_impl(carry, length=nsteps, phase=0)
            return jnp.stack([
                carry.slab.xl.ravel()[0],
                overflow.astype(jnp.float32),
                carry.monitors.migrate_dropped.astype(jnp.float32),
            ])

        out = np.asarray(one_run(pos, vel))  # compile + warm
        assert out[1] == 0 and out[2] == 0
        fts = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = np.asarray(one_run(pos, vel))
            fts.append(time.perf_counter() - t0)
        fused_best = min(fts)

        @jax.jit
        def kruns(pos, vel):
            def body(dep, _):
                # dep is exactly 0.0: bit-identical state, real dependence
                slab, overflow = grid_ops.slab_from_particles(
                    pos + dep, vel, engine.geom)
                carry = GridCarry(slab, jnp.zeros((), jnp.int32),
                                  Monitors.zeros())
                carry = engine._segment_impl(carry, length=nsteps, phase=0)
                dep2 = 0.0 * carry.slab.xl.ravel()[0]
                return dep2, (overflow, carry.monitors.migrate_dropped)
            dep, (ovf, drops) = jax.lax.scan(
                body, jnp.float32(0.0), None, length=K)
            return dep, ovf.max(), drops.max()

        dep, ovf, drops = kruns(pos, vel)  # compile + warm
        np.asarray(dep)
        assert int(ovf) == 0 and int(drops) == 0
        kts = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            dep, ovf, drops = kruns(pos, vel)
            np.asarray(dep)
            kts.append(time.perf_counter() - t0)
        k_best = min(kts)
        per_run = k_best / K

        rec = {
            "ab": "small_n",
            "engine": "pallas",
            "num_parts": n,
            "nsteps": args.steps,
            "k": K,
            "seconds_standard": std_best,
            "standard_times": [round(t, 5) for t in times],
            "seconds_fused_single": fused_best,
            "fused_times": [round(t, 5) for t in fts],
            "seconds_k_total": k_best,
            "k_times": [round(t, 5) for t in kts],
            "seconds_per_run_amortized": per_run,
            "psteps_standard": n * args.steps / std_best,
            "psteps_amortized": n * args.steps / per_run,
            "floor_per_exec": floor,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "p100_seconds": p100.get(n),
            "vs_p100_standard": (p100[n] / std_best) if n in p100 else None,
            "vs_p100_fused": (p100[n] / fused_best) if n in p100 else None,
            "vs_p100_amortized": (p100[n] / per_run) if n in p100 else None,
            "ts": time.time(),
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)

    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
