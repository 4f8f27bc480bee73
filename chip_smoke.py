#!/usr/bin/env python
"""On-chip smoke test: the main path on one NVIDIA GPU, in one process.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the sharded engines only

Phases (each raises on failure; the script then exits non-zero and never
prints its final line):

- device: JAX's first device is a GPU (no CPU fallback); JAX version and
  the card's name and power limit.
- kernel parity: one fused force+move step of the Triton kernel against the
  XLA twin (grid_force_xla + grid_move), at the 20.97M headline geometry and
  on a small ragged one, for both force laws.
- init parity: the fast initializer on the host and on the device agree
  exactly at 20.97M.
- main path: the reference contract (20.97M x 1000 steps) through
  harness.timed_run_repeats for ``pallas`` and ``grid``, monitors checked.
- checked trajectory: ``harness.main(... --engine pallas --check)`` at
  n=100k passes the checker.
- 3D: ``grid3d`` at 4.19M x 100 steps for both laws, monitors checked.

``--four`` runs sharded_grid (4x1 strips, the kernel per shard) and
sharded_tile (2x2, XLA) at 20.97M x 200 steps, each against the one-GPU
``pallas`` run of the same config, and prints every device's peak memory.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

HEADLINE_N = 20_971_520
HEADLINE_STEPS = 1000
FOUR_STEPS = 200
# Kernel parity bounds (one step from the same state). Not zero: the kernel's
# rsqrt is approximate, and Triton and XLA contract multiply-adds into FMAs
# differently.
VEL_TOL = 1e-5  # x max|v|
POS_TOL = 1e-6  # x bin size
# Four-GPU bounds on |pos - pos_1gpu| after FOUR_STEPS steps. The dynamics
# are chaotic: a last-bit difference (XLA fuses the sharded programs
# differently; the tile mesh runs the XLA force, not the kernel) grows with
# every collision. A 1e-7 velocity perturbation at 1M particles x 200 steps
# (XLA CPU) moved the median particle 7.6e-6, the 99.9th percentile 1.8e-3
# and the farthest 0.025. So the bulk is held to half a cutoff and the
# worst particle to eight bins' width — a wrong row offset, wall or
# migration moves particles by a box-scale distance, and a lost or
# duplicated particle fails the pid check before this.
FOUR_TOL = {"q999": 5e-3, "max": 0.5}


def log(*parts) -> None:
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def require_gpus(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} GPUs, have {len(devs)}")
    return devs


def jittered_state(config, seed: int, jitter: float):
    """The fast-init lattice with every coordinate moved by up to
    ``jitter``: lattice neighbours then come inside the cutoff, so a force
    step has pairs to evaluate (the plain lattice has none at the reference
    density)."""
    import jax
    import jax.numpy as jnp

    from ppsim_tpu.initlib import init_particles_fast

    pos, vel = init_particles_fast(config.num_parts, config.size, seed)
    d = jax.random.uniform(jax.random.PRNGKey(seed + 1), pos.shape,
                           jnp.float32, -jitter, jitter)
    return jnp.clip(pos + d, 0.0, config.size), vel


def jittered_slab(config, geom):
    """:func:`jittered_state` packed into ``geom`` (excess slots of a bin
    that overflows are dropped: the parity step only needs one slab)."""
    import jax

    from ppsim_tpu.ops import grid_ops

    pos, vel = jittered_state(config, 7, 0.8 * config.cutoff)
    slab, _ = jax.jit(lambda p, v: grid_ops.slab_from_particles(p, v, geom))(
        pos, vel)
    return slab


def kernel_parity(config, geom, slab):
    """One fused step of the kernel vs the XLA twin from a jittered state;
    returns {field: (max difference, tolerance)} and raises past a bound."""
    import jax
    import jax.numpy as jnp

    from ppsim_tpu.ops import grid_ops
    from ppsim_tpu.ops.pallas_grid import grid_step_pallas
    from ppsim_tpu.physics import accel_fn_for

    with jax.default_matmul_precision("highest"):
        kx, ky, kvx, kvy, ksp = grid_step_pallas(
            slab.xl, slab.yl, slab.vx, slab.vy, geom, config.cutoff,
            config.min_r, config.mass, config.dt, config.size,
            law=config.force_law, law_params=config.law_params)

        @jax.jit
        def twin(s):
            acc = grid_ops.grid_force_xla(
                s.xl, s.yl, geom, config.cutoff, config.min_r, config.mass,
                pair_fn=accel_fn_for(config))
            new, _ = grid_ops.grid_move(s, acc, geom, config.dt, config.size)
            sp = jnp.where(new.pid >= 0, new.vx ** 2 + new.vy ** 2, 0.0)
            return new, sp.max(axis=0)

        ref, rsp = twin(slab)
    vmax = float(jnp.maximum(jnp.abs(ref.vx).max(), jnp.abs(ref.vy).max()))
    vtol = VEL_TOL * vmax
    ptol = POS_TOL * geom.bin_size
    errs = {
        "xl": (float(jnp.abs(kx - ref.xl).max()), ptol),
        "yl": (float(jnp.abs(ky - ref.yl).max()), ptol),
        "vx": (float(jnp.abs(kvx - ref.vx).max()), vtol),
        "vy": (float(jnp.abs(kvy - ref.vy).max()), vtol),
        "speed": (float(jnp.abs(jnp.sqrt(ksp) - jnp.sqrt(rsp)).max()), vtol),
    }
    for name, (err, tol) in errs.items():
        if not err <= tol:
            raise AssertionError(
                f"kernel parity: {name} differs by {err:.3g} > {tol:.3g}")
    return errs


def ragged_geometry(config):
    """The config's geometry with no row/col padding: rows and cols that
    are not multiples of the kernel tile, so every edge tile is masked."""
    import dataclasses

    from ppsim_tpu.ops.grid_ops import SlabGeometry
    from ppsim_tpu.ops.pallas_grid import TILE_COLS, TILE_ROWS

    g = SlabGeometry.for_config(config)
    g = dataclasses.replace(g, rows_pad=g.rows, cols_pad=g.cols)
    assert g.rows % TILE_ROWS and g.cols % TILE_COLS, g
    return g


def run_phase_kernel_parity(n_big: int) -> None:
    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.ops.grid_ops import SlabGeometry

    for label, base in (
            (f"n={n_big}", SimConfig(num_parts=n_big)),
            ("ragged n=2400", SimConfig(num_parts=2400, grid_bin_scale=3.0,
                                        grid_capacity=8))):
        geom = (SlabGeometry.for_config(base) if base.num_parts == n_big
                else ragged_geometry(base))
        slab = jittered_slab(base, geom)  # shared by both laws
        for law in ("repulsive", "lj"):
            errs = kernel_parity(base.with_(force_law=law), geom, slab)
            log(f"kernel parity [{law}, {label}, grid {geom.rows_pad}x"
                f"{geom.cols_pad} cap {geom.capacity}]: " + ", ".join(
                    f"{k} {e:.3g} (tol {t:.3g})" for k, (e, t) in errs.items()))


def run_phase_init_parity(n: int) -> None:
    import numpy as np

    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.initlib import init_particles_fast

    cfg = SimConfig(num_parts=n)
    host = init_particles_fast(n, cfg.size, 42, host=True)
    dev = init_particles_fast(n, cfg.size, 42, host=False)
    for name, a, b in zip(("pos", "vel"), host, dev):
        a, b = np.asarray(a), np.asarray(b)
        ndiff = int((a != b).sum())
        log(f"init parity [{name}, n={n}]: {ndiff} of {a.size} values "
            "differ between host and device")
        if ndiff:
            raise AssertionError(f"init parity: {ndiff} {name} values differ")


def run_phase_main(n: int, steps: int, gpu: str) -> None:
    """The reference contract through the timed driver, with the engines'
    drop-detected capacity escalation (a run that drops particles raises
    its slot capacity and re-runs; the clean attempt is the one timed)."""
    import jax

    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.harness import timed_run_healing
    from ppsim_tpu.initlib import init_particles

    cfg = SimConfig(num_parts=n)
    state = init_particles(cfg, seed=42, method="fast")
    secs, engines = {}, {}
    for name in ("pallas", "grid"):
        engine = engines[name] = get_engine(name, cfg)
        result, times = timed_run_healing(engine, state, steps, 0)
        engine.check(result)
        secs[name] = times[0]
        m = result.monitors
        log(f"main path [{name}, n={n} x {steps}, capacity "
            f"{engine.capacity}, rebin every {engine.rebin_every}]: "
            f"{times[0]:.3f} s, {n * steps / times[0] / 1e6:.1f} M "
            f"particle-steps/s (max_bin_count {int(m.max_bin_count)}, "
            f"dropped {int(m.migrate_dropped)}, deferred {int(m.deferred)}, "
            f"max_speed {float(m.max_speed):.3f}) on {gpu}")
    # Rebin share of each run: the XLA rebin (both engines run the same
    # one) timed alone on a packed slab, times the rebins the run performs.
    for name, engine in engines.items():
        slab = engine.init_carry(state).slab
        rebin = jax.jit(engine.rebin_of)
        jax.block_until_ready(rebin(slab))
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = rebin(slab)
        jax.block_until_ready(out)
        per = (time.perf_counter() - t0) / reps
        nreb = steps // engine.rebin_every
        log(f"rebin [{name}, capacity {engine.capacity}]: {per * 1e3:.2f} ms "
            f"x {nreb} rebins = {per * nreb:.3f} s, "
            f"{100 * per * nreb / secs[name]:.1f}% of the {name} run")
        del slab, out
    log(f"pallas vs grid: {secs['grid'] / secs['pallas']:.2f}x "
        f"(pallas {secs['pallas']:.3f} s, grid {secs['grid']:.3f} s)")


def run_phase_checked(argv) -> None:
    from ppsim_tpu import harness

    rc = harness.main(argv)
    if rc != 0:
        raise AssertionError(f"checked trajectory: harness returned {rc}")


def run_phase_3d(n: int, steps: int) -> None:
    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.harness import timed_run
    from ppsim_tpu.initlib import init_particles

    for law, dt in (("repulsive", None), ("lj", 1e-4)):
        kw = {"dt": dt} if dt else {}
        cfg = SimConfig(num_parts=n, ndim=3, density=7e-6, force_law=law,
                        **kw)
        engine = get_engine("grid3d", cfg)
        state = init_particles(cfg, seed=42, method="fast")
        result, secs = timed_run(engine, state, steps, 0)
        engine.check(result)
        m = result.monitors
        log(f"3D [grid3d, {law}, n={n} x {steps}]: {secs:.3f} s, capacity "
            f"{engine.capacity}, max_bin_count {int(m.max_bin_count)}, "
            f"dropped {int(m.migrate_dropped)}, deferred {int(m.deferred)}")


def run_carry(engine, state, steps: int):
    """init_carry + the unsaved run program; returns the final carry."""
    carry = engine.init_carry(state)
    carry, _ = engine._program(steps, 0)(carry)
    return carry


def run_phase_four(n: int, steps: int, devices,
                   interpret: bool = False) -> None:
    """sharded_grid (4x1) and sharded_tile (2x2) against the one-device
    pallas run: every pid once, monitors clean, positions within bound."""
    import jax
    import numpy as np

    from ppsim_tpu.config import SimConfig
    from ppsim_tpu.engines.base import RunResult
    from ppsim_tpu.engines.grid import PallasGridEngine
    from ppsim_tpu.engines.sharded_grid import ShardedGridEngine
    from ppsim_tpu.engines.sharded_tile import ShardedTileEngine
    from ppsim_tpu.initlib import init_particles

    cfg = SimConfig(num_parts=n)
    state = init_particles(cfg, seed=42, method="fast")
    engines = {
        "sharded_grid": lambda: ShardedGridEngine(
            cfg, devices=devices, interpret=interpret),
        "sharded_tile": lambda: ShardedTileEngine(
            cfg, devices=devices, mesh_shape=(2, 2)),
    }
    finals = {}
    for name, make in engines.items():
        engine = make()
        t0 = time.perf_counter()
        carry = run_carry(engine, state, steps)
        final = engine.final_state_jit(carry)
        pid = np.asarray(carry.slab.pid).ravel()
        pid = pid[pid >= 0]
        counts = np.bincount(pid, minlength=n)
        if pid.size != n or counts.max() != 1:
            raise AssertionError(
                f"{name}: {pid.size} live slots, {int((counts == 0).sum())} "
                f"pids missing, {int((counts > 1).sum())} duplicated")
        mon = jax.tree.map(np.asarray, engine.monitors_of(carry))
        engine.check(RunResult(final, None, mon))
        finals[name] = np.asarray(final.pos)
        log(f"{name} [{'x'.join(map(str, engine.mesh.devices.shape))} mesh, "
            f"n={n} x {steps}]: every pid once, monitors clean "
            f"(dropped {int(mon.migrate_dropped)}, deferred "
            f"{int(mon.deferred)}), {time.perf_counter() - t0:.1f} s "
            "with compile")
    for d in devices:
        stats = d.memory_stats() or {}
        log(f"peak memory {d}: {stats.get('peak_bytes_in_use', 0) / 2**30:.3f}"
            " GiB")
    ref_engine = PallasGridEngine(cfg, interpret=interpret)
    ref = np.asarray(ref_engine.final_state_jit(
        run_carry(ref_engine, state, steps)).pos)
    for name, pos in finals.items():
        d = np.abs(pos - ref).max(axis=1)
        got = {"q999": float(np.quantile(d, 0.999)), "max": float(d.max())}
        log(f"{name} vs one-device pallas: |dpos| median "
            f"{float(np.median(d)):.3g}, " + ", ".join(
                f"{k} {v:.3g} (tol {FOUR_TOL[k]:.3g})"
                for k, v in got.items()))
        for k, v in got.items():
            if not v <= FOUR_TOL[k]:
                raise AssertionError(f"{name}: |dpos| {k} {v:.3g} > "
                                     f"{FOUR_TOL[k]:.3g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded engines")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1

    with phase("device"):
        import jax

        devs = require_gpus(count)
        gpu = card()
        log(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}")
        log(gpu)
        from ppsim_tpu.compile_cache import enable_compile_cache

        log(f"compile cache: {enable_compile_cache()}")

    if args.four:
        with phase("four GPUs"):
            run_phase_four(HEADLINE_N, FOUR_STEPS, devs[:4])
    else:
        with phase("kernel parity"):
            run_phase_kernel_parity(HEADLINE_N)
        with phase("init parity"):
            run_phase_init_parity(HEADLINE_N)
        with phase("main path"):
            run_phase_main(HEADLINE_N, HEADLINE_STEPS, gpu)
        with phase("checked trajectory"):
            run_phase_checked(["-n", "100000", "-s", "42", "--engine",
                               "pallas", "--check"])
        with phase("3D runs"):
            run_phase_3d(4_194_304, 100)

    log(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
