"""Engine parity and invariant tests (the rebuild's answer to SURVEY.md §4:
oracle comparison, determinism discipline, invariant asserts, and multi-rank
testing without a cluster)."""

import dataclasses

import numpy as np
import pytest

from ppsim_tpu.checker import check_frames
from ppsim_tpu.config import SimConfig
from ppsim_tpu.engines import get_engine
from ppsim_tpu.initlib import init_particles


@pytest.fixture(scope="module")
def state_and_config():
    cfg = SimConfig(num_parts=1500)
    return init_particles(cfg, seed=42, method="reference"), cfg


def test_binned_matches_oracle_bitexact(state_and_config):
    state, cfg = state_and_config
    r1 = get_engine("oracle", cfg).run(state, nsteps=50, savefreq=10)
    r2 = get_engine("binned", cfg).run(state, nsteps=50, savefreq=10)
    np.testing.assert_array_equal(r1.frames, r2.frames)
    r2.check(cfg)


def test_sharded_matches_binned_bitexact(state_and_config):
    state, cfg = state_and_config
    r1 = get_engine("binned", cfg).run(state, nsteps=60, savefreq=10)
    r2 = get_engine("sharded", cfg).run(state, nsteps=60, savefreq=10)
    np.testing.assert_array_equal(r1.frames, r2.frames)
    r2.check(cfg)


def test_sharded_migration_preserves_particles(state_and_config):
    state, cfg = state_and_config
    eng = get_engine("sharded", cfg)
    res = eng.run(state, nsteps=120)
    res.check(cfg)
    # every particle accounted for exactly once and inside the box
    pos = np.asarray(res.state.pos)
    assert pos.shape == (cfg.num_parts, 2)
    assert pos.min() >= 0.0 and pos.max() <= cfg.size


def test_grid_one_step_close_to_oracle(grid_test_config):
    cfg = grid_test_config
    state = init_particles(cfg, seed=42, method="reference")
    s1 = get_engine("oracle", cfg).step_state(state)
    s2 = get_engine("grid", cfg).step_state(state)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s2.pos), atol=5e-7
    )
    np.testing.assert_allclose(
        np.asarray(s1.vel), np.asarray(s2.vel), atol=2e-3
    )


@pytest.mark.slow
def test_grid_trajectory_passes_checker(grid_test_config):
    cfg = grid_test_config
    state = init_particles(cfg, seed=42, method="reference")
    res = get_engine("grid", cfg).run(state, nsteps=120, savefreq=10)
    res.check(cfg, capacity=cfg.grid_capacity)
    assert check_frames(res.frames, cfg).passed


@pytest.mark.slow
def test_pallas_interpret_matches_grid(grid_test_config):
    cfg = grid_test_config
    state = init_particles(cfg, seed=42, method="reference")
    s1 = get_engine("grid", cfg).step_state(state)
    s2 = get_engine("pallas", cfg, interpret=True).step_state(state)
    np.testing.assert_allclose(np.asarray(s1.pos), np.asarray(s2.pos), atol=1e-7)


def test_sharded_far_mover_converges_not_dropped():
    """A particle crossing >1 strip per step is deferred (one hop per step,
    converging), never dropped, and never duplicated (sharded.py's far-mover
    discipline; cf. the reference's move-exactly-once rule, mpi.cpp:341-346)."""
    import jax
    import jax.numpy as jnp

    from ppsim_tpu.state import ParticleState

    cfg = SimConfig(num_parts=256)
    eng = get_engine("sharded", cfg)
    state = init_particles(cfg, seed=1, method="reference")
    vel = np.asarray(state.vel).copy()
    # Fast enough to cross two strips in one dt (impossible dynamically;
    # injected to force the far-mover path).
    jump = 2.1 * eng.rows_per_shard * cfg.bin_size
    vel[0] = (jump / cfg.dt, 0.0)
    carry = eng.init_carry(ParticleState(state.pos, jnp.asarray(vel)))
    for _ in range(4):
        carry = eng.step_carry(carry)
    mon = jax.tree.map(np.asarray, eng.monitors_of(carry))
    assert int(mon.migrate_dropped) == 0
    assert int(mon.deferred) > 0
    pid = np.asarray(carry.pid)
    alive = pid[pid >= 0]
    assert alive.size == cfg.num_parts  # nothing lost
    assert np.unique(alive).size == cfg.num_parts  # nothing duplicated


def test_pallas_interpret_one_step_fast(tiny_grid_config):
    """Fast-suite flagship coverage: tiny-config Triton step (interpret mode)
    against the XLA twin. The heavyweight full-config parity runs stay in the
    slow suite; this catches kernel regressions inside the 2-minute gate."""
    cfg = tiny_grid_config
    state = init_particles(cfg, seed=42, method="reference")
    s1 = get_engine("grid", cfg).step_state(state)
    s2 = get_engine("pallas", cfg, interpret=True).step_state(state)
    np.testing.assert_allclose(np.asarray(s1.pos), np.asarray(s2.pos), atol=1e-7)


def test_sharded_grid_two_device_fast(tiny_grid_config):
    """Fast-suite flagship coverage: 2-device sharded_grid (halo + one rebin
    boundary crossing) against the single-chip grid engine."""
    import jax

    from ppsim_tpu.engines.sharded_grid import ShardedGridEngine

    cfg = tiny_grid_config
    state = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(state, nsteps=8)
    eng = ShardedGridEngine(cfg, devices=jax.devices()[:2], interpret=True)
    r2 = eng.run(state, nsteps=8)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=2e-6
    )
    assert int(r2.monitors.migrate_dropped) == 0


def test_bin_overflow_detected():
    cfg = SimConfig(num_parts=1000, bin_capacity=1)
    state = init_particles(cfg, seed=42, method="reference")
    res = get_engine("binned", cfg).run(state, nsteps=5)
    with pytest.raises(RuntimeError, match="bin overflow"):
        res.check(cfg)


def test_grid_pack_overflow_deferred_to_check():
    """An under-provisioned grid engine must NOT raise in init_carry (the
    eager int(overflow) there was a device->host sync inside the reference
    timing contract's region — the r4 small-n floor attribution); the pack
    overflow rides the monitors and surfaces through check() post-run."""
    import jax

    cfg = SimConfig(num_parts=1000, grid_bin_scale=3.0, grid_capacity=1,
                    evac_capacity=1, rebin_every=4)
    state = init_particles(cfg, seed=42, method="fast")
    eng = get_engine("grid", cfg)
    carry = eng.init_carry(state)  # must not raise, must not sync
    mon = jax.tree.map(np.asarray, eng.monitors_of(carry))
    assert int(mon.max_bin_count) > eng.capacity  # exact initial packing
    res = eng.run(state, nsteps=4)
    with pytest.raises(RuntimeError, match="bin overflow"):
        eng.check(res)


def test_grid_auto_capacity_self_heals_end_to_end():
    """2D drop-detected capacity escalation (the r5 port of the r4 3D
    machinery; motivated by the 20.97M 2D LJ headline dropping 44 particles
    at the chooser's capacity): an AUTO-capacity run whose t=0 packing
    overflows the chooser pick must re-run at the measured packing and come
    out loss-free — no hand flags."""
    import jax.numpy as jnp

    from ppsim_tpu.state import ParticleState

    cfg = SimConfig(num_parts=16)
    eng = get_engine("grid", cfg)
    cap0 = eng.geom.capacity
    assert cap0 < 16  # the scenario must actually overflow the chooser pick
    # 16 static particles in one 0.05-side bin, pairwise > cutoff (0.0135
    # grid spacing): zero forces, zero velocity — positions must survive
    # the heal byte-for-byte.
    xs = np.linspace(0.004, 0.0445, 4)
    pos = np.stack(np.meshgrid(xs, xs), -1).reshape(16, 2).astype(np.float32)
    state = ParticleState(jnp.asarray(pos), jnp.zeros((16, 2), jnp.float32))

    res = eng.run(state, nsteps=4)
    assert eng.geom.capacity == 16          # escalated to the exact packing
    eng.check(res)                          # clean after the heal
    assert int(res.monitors.migrate_dropped) == 0
    np.testing.assert_array_equal(np.asarray(res.state.pos), pos)


def test_grid_escalation_gates():
    """The heal never fires for hand capacities (ablations under-provision
    on purpose) and the 2D sharded engines opt out (their shard_map
    closures bind geometry at init)."""
    import jax
    import jax.numpy as jnp

    from ppsim_tpu.engines.base import Monitors, RunResult

    fake = RunResult(None, None, Monitors(jnp.int32(0), jnp.int32(3),
                                          jnp.float32(0.0), jnp.int32(0)))

    hand = get_engine("grid", SimConfig(num_parts=1000, grid_capacity=1,
                                        evac_capacity=1))
    assert not hand.maybe_escalate_after_drop(fake)

    auto = get_engine("grid", SimConfig(num_parts=1000))
    cap0 = auto.geom.capacity
    assert auto.maybe_escalate_after_drop(fake)
    assert auto.geom.capacity == cap0 + 1

    from ppsim_tpu.engines.sharded_grid import ShardedGridEngine

    sharded = ShardedGridEngine(SimConfig(num_parts=1000),
                                devices=jax.devices()[:2], impl="xla")
    assert not sharded.maybe_escalate_after_drop(fake)


def test_unknown_engine_rejected():
    with pytest.raises(ValueError, match="unknown engine"):
        get_engine("cuda", SimConfig())


def test_energy_and_containment_invariants(state_and_config):
    state, cfg = state_and_config
    res = get_engine("binned", cfg).run(state, nsteps=100)
    res.check(cfg)
    pos = np.asarray(res.state.pos)
    vel = np.asarray(res.state.vel)
    assert pos.min() >= 0.0 and pos.max() <= cfg.size
    # repulsion-only dynamics with dt=5e-4 keeps speeds bounded
    assert np.abs(vel).max() < 10.0


def test_chunked_timed_run_matches_monolithic(grid_test_config):
    """timed_run_repeats(chunk_steps=...) must execute the exact same step
    sequence as the monolithic program (chunk boundaries preserve the rebin
    cadence phase), yielding a bit-identical final state."""
    from ppsim_tpu.harness import timed_run_repeats

    state = init_particles(grid_test_config, seed=42, method="fast")
    ra, _ = timed_run_repeats(
        get_engine("grid", grid_test_config), state, 16, 0, repeats=1)
    rb, _ = timed_run_repeats(
        get_engine("grid", grid_test_config), state, 16, 0, repeats=1,
        chunk_steps=8)
    assert np.array_equal(np.asarray(ra.state.pos), np.asarray(rb.state.pos))
    assert np.array_equal(np.asarray(ra.state.vel), np.asarray(rb.state.vel))
    with pytest.raises(ValueError):
        timed_run_repeats(get_engine("grid", grid_test_config), state, 16, 0,
                          repeats=1, chunk_steps=6)  # not a cadence multiple


def test_axes_rebin_mode_engine_parity(tiny_grid_config):
    """grid_rebin_mode='axes' end-to-end: the kernel (interpret) engine must
    stay bit-exact with the XLA twin across several rebin rounds, and the
    axes trajectory must match dirs9 to f32 summation order."""
    cfg = dataclasses.replace(tiny_grid_config, grid_rebin_mode="axes")
    state = init_particles(cfg, seed=42, method="reference")
    ga = get_engine("grid", cfg).run(state, nsteps=12, savefreq=0)
    pa = get_engine("pallas", cfg, interpret=True).run(state, nsteps=12,
                                                       savefreq=0)
    np.testing.assert_array_equal(np.asarray(ga.state.pos),
                                  np.asarray(pa.state.pos))
    ga.check(cfg, capacity=cfg.grid_capacity)
    pa.check(cfg, capacity=cfg.grid_capacity)
    g9 = get_engine("grid", tiny_grid_config).run(state, nsteps=12, savefreq=0)
    np.testing.assert_allclose(np.asarray(ga.state.pos),
                               np.asarray(g9.state.pos), atol=1e-6)
