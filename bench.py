#!/usr/bin/env python
"""Headline benchmark: particle-steps/sec of the flagship (pallas) engine.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline (BASELINE.md): the reference's CUDA part3 on a Tesla P100 runs its
largest config, n=16,384,000 x 1000 steps, in 50.85 s (part3 PDF Tables 1&3)
— 322.2 M particle-steps/sec. ``vs_baseline`` is our sustained
particle-steps/sec divided by that. Timing follows the reference contract
(part1/main.cpp:118-143): engine init + all steps, excluding jit compile
(the C++ builds are AOT-compiled too) and excluding particle initialization.

The timed region runs ``--repeats`` times in one process on one compiled
program; ``value`` is the BEST run. The per-run seconds, the relative
spread, the safety-monitor state and the device it ran on are all in the
JSON, so a regression (or a noisy capture) is visible, not silent.

The benchmark measures an NVIDIA GPU and nothing else: without one it fails
rather than timing the CPU backend.

Usage:
    python bench.py                  # full: n=20.97M x 1000 steps, best of 3
    python bench.py --quick          # small smoke (n=262144 x 200)
    python bench.py -n 4194304 --steps 1000 --repeats 5 --baseline 331.3e6
"""

import argparse
import json
import subprocess
import sys

P100_PSTEPS_BEST = 16_384_000 * 1000 / 50.85  # 322.2M, part3 PDF Tables 1&3


def require_gpu():
    """The first device, or SystemExit when JAX's default backend is not an
    NVIDIA GPU (no CPU fallback: a CPU time is not a measurement of the
    system)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures an NVIDIA GPU; JAX found platform "
            f"{dev.platform!r} ({dev.device_kind})")
    return dev


def gpu_name_and_power_limit():
    """``(name, power_limit_w)`` of the first card, as nvidia-smi reports
    them (None where nvidia-smi is unavailable)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        name, limit = out.splitlines()[0].rsplit(",", 1)
        return name.strip(), float(limit)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=20_971_520)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--engine", default="pallas")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--baseline", type=float, default=P100_PSTEPS_BEST,
                    help="baseline particle-steps/sec to compare against")
    # Stretch-config axes (same flags as bench/sweep.py): the headline tool
    # can drive the 3D / Lennard-Jones configs too, e.g.
    #   python bench.py --ndim 3 --density 7e-6
    ap.add_argument("--ndim", type=int, default=2)
    ap.add_argument("--density", type=float, default=None)
    ap.add_argument("--force-law", default=None, help="repulsive | lj")
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--grid3-capacity", type=int, default=None)
    ap.add_argument("--rebin-every", type=int, default=None,
                    help="rebin cadence (default: the config's)")
    ap.add_argument("--chunk-steps", type=int, default=None,
                    help="N async invocations of one compiled chunk program "
                         "instead of one program for all steps (timing "
                         "contract unchanged)")
    args = ap.parse_args(argv)
    if args.quick:
        args.n, args.steps = 262_144, 200
    dev = require_gpu()

    from ppsim_tpu.compile_cache import enable_compile_cache
    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.harness import timed_run_healing
    from ppsim_tpu.initlib import init_particles

    enable_compile_cache()
    # --rebin-every maps to the dimension's cadence field (rebin3_every in
    # 3D), same as the CLI harness.
    cadence_key = "rebin_every" if args.ndim == 2 else "rebin3_every"
    kw = {k: v for k, v in (("density", args.density),
                            ("force_law", args.force_law),
                            ("dt", args.dt),
                            ("grid3_capacity", args.grid3_capacity),
                            (cadence_key, args.rebin_every))
          if v is not None}
    if args.ndim != 2:
        kw["ndim"] = args.ndim
        if args.engine == "pallas":  # the 3D family runs XLA ops only
            args.engine = "grid3d"
    config = SimConfig(num_parts=args.n, **kw)
    state = init_particles(config, seed=42, method="fast")
    engine = get_engine(args.engine, config)
    # Auto-capacity engines that drop particles escalate one slot and
    # re-run; the JSON records the capacity the clean run used.
    result, times = timed_run_healing(engine, state, args.steps, 0,
                                      repeats=args.repeats,
                                      chunk_steps=args.chunk_steps)
    engine.check(result)  # raises if any safety monitor tripped

    import jax

    best = min(times)
    psteps = args.n * args.steps / best
    gpu_name, power_limit = gpu_name_and_power_limit()
    print(
        json.dumps(
            {
                "metric": f"particle_steps_per_sec[{args.engine},n={args.n},steps={args.steps}]",
                "value": round(psteps, 1),
                "unit": "particle-steps/s",
                "vs_baseline": round(psteps / args.baseline, 3),
                "seconds_per_run": [round(t, 3) for t in times],
                "spread": round((max(times) - best) / best, 3),
                "monitors": {
                    "max_bin_count": int(result.monitors.max_bin_count),
                    "dropped": int(result.monitors.migrate_dropped),
                    "deferred": int(result.monitors.deferred),
                    "max_speed": float(result.monitors.max_speed),
                },
                "config": {"rebin_every": getattr(engine, "rebin_every", None),
                           "capacity": engine.capacity,
                           "grid_pack_mode": config.grid_pack_mode},
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                "gpu_name": gpu_name,
                "power_limit_w": power_limit,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
