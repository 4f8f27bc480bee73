"""3D dense slab-grid engines (grid3d / sharded_grid3d): parity with the 3D
oracle and conservation through the 27-direction rebin."""

import numpy as np
import pytest

from ppsim_tpu.config import SimConfig
from ppsim_tpu.engines import get_engine
from ppsim_tpu.initlib import init_particles

BASE3 = dict(ndim=3, density=7e-6, grid3_capacity=8, evac_capacity=2,
             rebin3_every=4)


@pytest.fixture
def cfg3():
    return SimConfig(num_parts=500, **BASE3)


def _one_plain_step(engine, state):
    """One force+move step, skipping the rebin program (the 27-direction
    shuffle costs ~8 min of XLA CPU compile; the fast suite exercises it
    nowhere near that budget — the slow trajectory tests cover it)."""
    import jax

    carry = engine.init_carry(state)
    carry = jax.jit(engine.step_plain)(carry)
    return engine.final_state_jit(carry)


def test_grid3d_auto_raises_capacity_from_initial_packing(cfg3):
    """An under-capacity 3D config must auto-raise to the measured initial
    packing (+ law-keyed run-tail slots) instead of demanding hand flags —
    the r3 stretch rows needed --grid3-capacity passed by hand because the
    20.97M lattice packs past the default (r4 fix). The raised engine's
    first step must match an engine built at the raised capacity."""
    import dataclasses

    import jax
    import numpy as np

    from ppsim_tpu.engines.grid3d import Grid3DEngine

    st = init_particles(cfg3, seed=42, method="fast")
    ref = Grid3DEngine(cfg3)  # cap 8 fits this packing (dryrun: peaks at 8)
    assert int(ref._pack_jit()(st.pos, st.vel)[1]) == 0

    low = Grid3DEngine(dataclasses.replace(cfg3, grid3_capacity=5))
    carry = low.init_carry(st)  # must auto-raise, not raise
    packing = low.capacity  # repulsive run-tail margin is 0
    assert 5 < packing <= ref.capacity
    assert int(low._pack_jit()(st.pos, st.vel)[1]) == 0
    # Capacity is pure headroom: the raised engine's physics matches an
    # engine that fit from the start (empty slots are inert sentinels).
    carry = jax.jit(low.step_plain)(carry)
    ref_carry = jax.jit(ref.step_plain)(ref.init_carry(st))
    np.testing.assert_allclose(
        np.asarray(low.final_state_jit(carry).pos),
        np.asarray(ref.final_state_jit(ref_carry).pos), atol=1e-6,
    )

    # LJ keys one extra run-tail slot on top of the measured packing.
    lj = Grid3DEngine(dataclasses.replace(
        cfg3, grid3_capacity=5, force_law="lj", dt=1e-4))
    lj.init_carry(st)
    assert lj.capacity == packing + 1


def test_grid3d_one_step_matches_oracle(cfg3):
    state = init_particles(cfg3, seed=42, method="fast")
    s1 = get_engine("oracle", cfg3).step_state(state)
    s2 = _one_plain_step(get_engine("grid3d", cfg3), state)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s2.pos), atol=5e-7
    )


def _aniso_geom(cfg, ys=5, xs=8, zs=4, capacity=8):
    """A hand-built anisotropic (lane-snapped-style) geometry covering the
    domain: per-axis bin sides differ, like Geometry3S.for_config's snapped
    candidates at benchmark sizes (tiny test grids fall back to isotropic,
    so the per-axis code paths need an explicit geometry)."""
    from ppsim_tpu.ops.grid3d_ops import Geometry3S

    L = cfg.size
    return Geometry3S(
        ys=ys, xs=xs, zs=zs, xs_pad=xs, zs_pad=128, ys_pad=ys,
        capacity=capacity, bsy=L / ys, bsx=L / xs, bsz=L / zs,
    )


def test_grid3d_anisotropic_step_matches_oracle(cfg3):
    """One XLA force+move step on per-axis bin sides against the O(N^2)
    oracle: packing, 27-plane offsets, and move offsets must all use the
    correct axis's bin side."""
    import jax
    import numpy as np

    from ppsim_tpu.engines.grid3d import _coef_of
    from ppsim_tpu.ops import grid3d_ops

    state = init_particles(cfg3, seed=42, method="fast")
    s1 = get_engine("oracle", cfg3).step_state(state)

    geom = _aniso_geom(cfg3)
    slab, overflow = jax.jit(
        lambda p, v: grid3d_ops.slab3_from_particles(p, v, geom)
    )(state.pos, state.vel)
    assert int(overflow) == 0

    def step(s):
        accel = grid3d_ops.grid3_force_xla(s.xl, s.yl, s.zl, geom,
                                           _coef_of(cfg3))
        new, _ = grid3d_ops.grid3_move(s, accel, geom, cfg3.dt, cfg3.size)
        return new

    new = jax.jit(step)(slab)
    pos, vel = grid3d_ops.slab3_to_particles(new, geom, cfg3.num_parts)
    np.testing.assert_allclose(np.asarray(s1.pos), np.asarray(pos), atol=5e-7)
    np.testing.assert_allclose(np.asarray(s1.vel), np.asarray(vel), atol=5e-5)


def test_rebin3_anisotropic_conserves_and_matches(cfg3):
    """Drifted anisotropic slab: the rebin must conserve all particles and
    relocate storage only — every particle's global position and velocity
    match the pre-rebin state (per-axis inv-bin-size in
    slab3_dirs/_axis_shuffle is what's under test)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ppsim_tpu.ops import grid3d_ops

    state = init_particles(cfg3, seed=3, method="fast")
    geom = _aniso_geom(cfg3)
    slab, _ = jax.jit(
        lambda p, v: grid3d_ops.slab3_from_particles(p, v, geom)
    )(state.pos, state.vel)
    rng = np.random.default_rng(0)
    # Per-axis drift scaled to each axis's own bin side (crossing-heavy).
    d = rng.uniform(0.3, 0.45, (3,)) * np.array([geom.bsx, geom.bsy, geom.bsz])
    alive = slab.pid >= 0
    slab = slab._replace(
        xl=jnp.where(alive, slab.xl + d[0], slab.xl),
        yl=jnp.where(alive, slab.yl - d[1], slab.yl),
        zl=jnp.where(alive, slab.zl + d[2], slab.zl),
    )
    a, amon = jax.jit(
        lambda s: grid3d_ops.grid3_rebin_axes(s, geom, cfg3.evac_capacity)
    )(slab)
    assert int(amon.dropped) == 0
    assert int((np.asarray(a.pid) >= 0).sum()) == cfg3.num_parts
    pa, va = grid3d_ops.slab3_to_particles(a, geom, cfg3.num_parts)
    pb, vb = grid3d_ops.slab3_to_particles(slab, geom, cfg3.num_parts)
    # re-centring a coordinate into the destination bin rounds once
    np.testing.assert_allclose(np.asarray(pa), np.asarray(pb), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


def test_geometry3s_snap_invariants():
    """for_config's snapped candidates: cover the domain, hold occupancy
    (bsx*bsy*bsz == b0^3), land z on the 128-lane grid and x on the
    8-sublane grid, and keep at least 1 step of stale slack."""
    from ppsim_tpu.ops.grid3d_ops import Geometry3S

    for n in (1_000_000, 16_777_216):
        cfg = SimConfig(num_parts=n, ndim=3, density=7e-6)
        g = Geometry3S.for_config(cfg)
        L = cfg.size
        assert g.xs * g.bsx >= L - 1e-9
        assert g.ys * g.bsy >= L - 1e-9
        assert g.zs * g.bsz >= L - 1e-9
        assert abs(g.bsx * g.bsy * g.bsz - cfg.grid3_bin_size ** 3) < 1e-12
        assert g.zs % 128 == 0 and g.xs % 8 == 0
        assert g.cadence(cfg) >= 1
        assert min(g.bsx, g.bsy, g.bsz) >= (
            cfg.cutoff + 2 * cfg.grid3_vmax * cfg.dt - 1e-12
        )
        # anisotropy headroom: any thin snapped axis gets extra capacity
        # slots (calibrated at n=1M and 16.8M, see
        # Geometry3S.for_config), never less than the auto base (these
        # configs are repulsive, so no LJ floor applies)
        import math as _math
        from ppsim_tpu.ops.grid3d_ops import _AUTO3_BASE_CAPACITY
        ratio = cfg.grid3_bin_size / min(g.bsx, g.bsy, g.bsz)
        assert g.capacity == _AUTO3_BASE_CAPACITY + min(
            2, max(0, _math.ceil(2.0 * (ratio - 1.0) - 1e-9)))
        # capacity-weighted padded volume never exceeds the isotropic
        # fallback's (the snap only wins when lane savings beat the
        # headroom tax)
        iso = Geometry3S.for_config(
            SimConfig(num_parts=n, ndim=3, density=7e-6,
                      grid3_snap_lanes=False))
        assert (g.capacity * g.ys * g.xs_pad * g.zs_pad
                <= iso.capacity * iso.ys * iso.xs_pad * iso.zs_pad)


@pytest.mark.slow
def test_grid3d_trajectory_matches_oracle(cfg3):
    state = init_particles(cfg3, seed=42, method="fast")
    r1 = get_engine("oracle", cfg3).run(state, nsteps=16)
    eng = get_engine("grid3d", cfg3)
    r2 = eng.run(state, nsteps=16)
    eng.check(r2)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=5e-5
    )
    pos = np.asarray(r2.state.pos)
    assert pos.min() >= 0.0 and pos.max() <= cfg3.size


@pytest.mark.slow
def test_grid3d_lj_matches_oracle():
    """The full stretch config: 3D + truncated Lennard-Jones through the
    dense slab engine (BASELINE.json configs[4])."""
    cfg = SimConfig(num_parts=400, force_law="lj", dt=1e-4, **BASE3)
    state = init_particles(cfg, seed=7, method="fast")
    r1 = get_engine("oracle", cfg).run(state, nsteps=12)
    r2 = get_engine("grid3d", cfg).run(state, nsteps=12)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=5e-5
    )


@pytest.mark.slow
def test_sharded_grid3d_matches_grid3d():
    """Multi-device 3D: y-strip halo + cross-shard migration through the
    extended rebin tracks the single-device grid3d engine."""
    import jax

    from ppsim_tpu.engines.sharded_grid3d import ShardedGrid3DEngine

    cfg = SimConfig(num_parts=600, **BASE3)
    state = init_particles(cfg, seed=42, method="fast")
    r1 = get_engine("grid3d", cfg).run(state, nsteps=12)
    eng = ShardedGrid3DEngine(cfg, devices=jax.devices()[:4])
    r2 = eng.run(state, nsteps=12)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=2e-6
    )
    assert int(r2.monitors.migrate_dropped) == 0


@pytest.mark.slow
def test_sharded_grid3d_conserves_particles_long_run():
    """3D twin of the 2D long-run conservation test: >= 30 rebin rounds so
    slow leaks across the y-strip boundary (one-sided acceptance, ghost-slab
    staleness) get a real chance to show (the 12-step parity test above sees
    only 2-3 rebins)."""
    import jax

    from ppsim_tpu.engines.sharded_grid3d import ShardedGrid3DEngine

    cfg = SimConfig(num_parts=600, **BASE3)
    state = init_particles(cfg, seed=11, method="fast")
    eng = ShardedGrid3DEngine(cfg, devices=jax.devices()[:4])
    res = eng.run(state, nsteps=128)  # rebin3_every=4 -> 32 rebin rounds
    eng.check(res)
    pos = np.asarray(res.state.pos)
    assert pos.shape[0] == cfg.num_parts
    assert int(res.monitors.migrate_dropped) == 0
    assert pos.min() >= 0.0 and pos.max() <= cfg.size


def test_lj_capacity_floor_at_benchmark_scales():
    """Pin the auto-capacity chooser's LJ floor to the measured boundary
    (ops/grid3d_ops.py _LJ_FLOOR_* calibration: effective 11 passes at
    <=1.09M bins, drops at 5.45M bins, effective 13 passes there —
    the recorded LJ capacity and occupancy-curve runs).
    Update alongside any recalibration."""
    from ppsim_tpu.ops.grid3d_ops import Geometry3S

    def cap(n, law):
        cfg = SimConfig(num_parts=n, ndim=3, density=7e-6,
                        force_law=law, dt=1e-4 if law == "lj" else 5e-4)
        return Geometry3S.for_config(cfg).capacity

    # Below the floor threshold the LJ choice equals the repulsive one.
    assert cap(1_048_576, "lj") == cap(1_048_576, "repulsive") == 12
    assert cap(4_194_304, "lj") == cap(4_194_304, "repulsive") == 11
    # At the stretch scale LJ gets the measured-safe floor; repulsive
    # stays at the base (its run max never exceeds the lattice packing).
    assert cap(20_971_520, "repulsive") == 11
    assert cap(20_971_520, "lj") == 13
    # Hand-set capacity wins over the floor (ablations under-provision
    # on purpose).
    hand = SimConfig(num_parts=20_971_520, ndim=3, density=7e-6,
                     force_law="lj", dt=1e-4, grid3_capacity=9)
    assert Geometry3S.for_config(hand).capacity in (9, 10, 11)


def test_drop_detected_capacity_escalation(monkeypatch):
    """Auto-capacity Grid3D runs self-heal on dropped particles: raise one
    slot, re-run from the initial state; hand-set capacities never retry
    (unit-level — the base run is stubbed so no 3D XLA compile happens)."""
    import jax.numpy as jnp

    from ppsim_tpu.engines import base as base_mod
    from ppsim_tpu.engines.base import Monitors, RunResult
    from ppsim_tpu.engines.grid3d import Grid3DEngine

    def result(dropped):
        m = Monitors(jnp.int32(0), jnp.int32(dropped), jnp.float32(0.0),
                     jnp.int32(0))
        return RunResult(None, None, m)

    calls = []

    def fake_run(self, state, nsteps=None, savefreq=0, **kw):
        calls.append(self.geom.capacity)
        # Drop until capacity reaches start + 2 (forces two escalations).
        return result(0 if self.geom.capacity >= calls[0] + 2 else 3)

    monkeypatch.setattr(base_mod.Engine, "run", fake_run)

    auto = Grid3DEngine(SimConfig(num_parts=500, ndim=3, density=7e-6))
    start = auto.geom.capacity
    res = auto.run(None)
    assert calls == [start, start + 1, start + 2]
    assert int(res.monitors.migrate_dropped) == 0
    assert auto.geom.capacity == start + 2

    calls.clear()
    hand = Grid3DEngine(SimConfig(num_parts=500, ndim=3, density=7e-6,
                                  grid3_capacity=start))
    res = hand.run(None)
    assert calls == [start]  # no retry: the drop surfaces to check()
    assert int(res.monitors.migrate_dropped) == 3


# ------------------------------------------------ capacity-phase repack
def _repack_cluster_state():
    """Deterministic repack scenario (r5, verdict #1 machinery): five
    particles packed into one bin (pairwise > cutoff, so zero forces —
    pure ballistic), each mover crossing into a distinct neighbor bin
    within a step or two; five stationary background singles elsewhere.
    Initial packing = 5, dispersed max occupancy = 1."""
    import jax.numpy as jnp

    from ppsim_tpu.state import ParticleState

    # box side 0.15, bin side 0.03 (scale 3): 5x5x5 bins; cluster bin (2,2,2)
    pos = np.array([
        [0.087, 0.075, 0.075],   # +x mover, 0.003 from the +x face
        [0.063, 0.075, 0.075],   # -x mover
        [0.075, 0.087, 0.075],   # +y mover
        [0.075, 0.063, 0.075],   # -y mover
        [0.075, 0.075, 0.087],   # +z mover
        [0.015, 0.015, 0.015],   # background singles, v = 0
        [0.135, 0.015, 0.015],
        [0.015, 0.135, 0.015],
        [0.015, 0.015, 0.135],
        [0.135, 0.135, 0.135],
    ], np.float32)
    vel = np.zeros((10, 3), np.float32)
    vel[0, 0] = 0.9
    vel[1, 0] = -0.9
    vel[2, 1] = 0.9
    vel[3, 1] = -0.9
    vel[4, 2] = 0.9
    return ParticleState(jnp.asarray(pos), jnp.asarray(vel))


def _repack_cfg(**kw):
    # density gives box side (10 * 3.375e-4)^(1/3) = 0.15; dt 0.01 at
    # |v| = 0.9 crosses a face-adjacent mover into its neighbor bin in one
    # step while keeping stale drift (1 * 0.9 * 0.01) under the slack 0.01.
    base = dict(num_parts=10, ndim=3, density=3.375e-4, grid3_bin_scale=3.0,
                grid3_capacity=4, evac_capacity=4, rebin3_every=1, dt=0.01,
                grid3_prologue_steps=2)
    base.update(kw)
    return SimConfig(**base)


def test_repack_phased_timed_run_commits_and_matches():
    """The capacity-phase repack (verdict r4 #1: the t=0 lattice-packing
    capacity tax): an under-capacity hand config packs at 5 (auto-raise),
    runs the prologue there, and the timed driver's verified repack drops
    it to the hand run capacity once the cluster disperses. Physics must
    match a generously-provisioned run (the repack is storage relocation
    only)."""
    from ppsim_tpu.harness import timed_run_repeats

    state = _repack_cluster_state()
    eng = get_engine("grid3d", _repack_cfg())
    result, times = timed_run_repeats(eng, state, 8, 0, repeats=2,
                                      chunk_steps=2)
    assert eng._pack_capacity == 5       # measured initial packing (+0 tail)
    assert eng.geom.capacity == 4        # the repack committed
    eng.check(result)                    # monitors clean at the pack gate
    assert int(result.monitors.migrate_dropped) == 0
    # Rebin monitors only see post-step occupancy (the cluster disperses in
    # step 1), so the running max is the dispersed occupancy, within the
    # run-capacity gate.
    assert int(result.monitors.max_bin_count) <= 4

    ref = get_engine("grid3d", _repack_cfg(grid3_capacity=6))
    ref_res, _ = timed_run_repeats(ref, state, 8, 0, repeats=1)
    assert ref.geom.capacity == 6        # fits from the start: no phases
    np.testing.assert_allclose(np.asarray(result.state.pos),
                               np.asarray(ref_res.state.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(result.state.vel),
                               np.asarray(ref_res.state.vel), atol=1e-6)


def test_repack_first_chunk_splits_at_plan_boundary():
    """Chunked phased runs split the FIRST chunk at the plan's earliest
    eligible boundary (min_s), so the repack lands as soon as the lattice
    disperses instead of waiting out a whole chunk at the packing
    capacity (the headline case: chunk 200 vs disperse-by-40)."""
    from ppsim_tpu.harness import timed_run_repeats

    state = _repack_cluster_state()
    eng = get_engine("grid3d", _repack_cfg())  # prologue_steps=2
    result, _ = timed_run_repeats(eng, state, 8, 0, repeats=1, chunk_steps=4)
    assert eng._pack_capacity == 5
    assert eng.geom.capacity == 4            # committed at the split boundary
    eng.check(result)
    ref = get_engine("grid3d", _repack_cfg(grid3_capacity=6))
    ref_res, _ = timed_run_repeats(ref, state, 8, 0, repeats=1)
    np.testing.assert_allclose(np.asarray(result.state.pos),
                               np.asarray(ref_res.state.pos), atol=1e-6)


def test_repack_phased_saved_run_commits_and_passes():
    """The saved (checker-gate) driver runs the same capacity phases: frames
    at the reference cadence, repack at a segment boundary, monitors clean."""
    from ppsim_tpu.harness import timed_run_repeats

    state = _repack_cluster_state()
    eng = get_engine("grid3d", _repack_cfg())
    result, times = timed_run_repeats(eng, state, 8, 2, repeats=1,
                                      chunk_steps=3)
    assert eng.geom.capacity == 4
    eng.check(result)
    assert result.frames.shape == (4, 10, 3)  # after steps 1, 3, 5, 7
    ref = get_engine("grid3d", _repack_cfg(grid3_capacity=6))
    ref_res, _ = timed_run_repeats(ref, state, 8, 2, repeats=1)
    np.testing.assert_allclose(result.frames, ref_res.frames, atol=1e-6)


def test_repack_failed_attempt_retries_and_stays_lossless():
    """A repack attempt BEFORE the cluster disperses must fail loss-free and
    retry at the next boundary (r5: attempt_repack donates its input and a
    failed attempt re-packs at the current capacity — a fused no-donation
    program would hold both slabs at once). Slow movers (v=0.12: the
    0.003 face gap crosses at step 3) keep the cluster packed at the first
    attempt (step 2) and disperse it by the second (step 4); physics must
    still match a generously-provisioned run through the failed attempt's
    slot reordering."""
    import jax.numpy as jnp

    from ppsim_tpu.harness import timed_run_repeats
    from ppsim_tpu.state import ParticleState

    base = _repack_cluster_state()
    vel = np.asarray(base.vel).copy()
    vel[np.nonzero(vel)] = np.sign(vel[np.nonzero(vel)]) * 0.12
    state = ParticleState(base.pos, jnp.asarray(vel))

    eng = get_engine("grid3d", _repack_cfg())  # prologue_steps=2
    result, _ = timed_run_repeats(eng, state, 8, 0, repeats=2, chunk_steps=2)
    assert eng._pack_capacity == 5
    assert eng._last_repack_attempts[0] == 2      # first attempt: still packed
    assert len(eng._last_repack_attempts) >= 2    # ... so it retried
    assert eng._last_repack_switch == eng._last_repack_attempts[-1]
    assert eng.geom.capacity == 4                 # the retry committed
    eng.check(result)
    assert int(result.monitors.migrate_dropped) == 0

    ref = get_engine("grid3d", _repack_cfg(grid3_capacity=6))
    ref_res, _ = timed_run_repeats(ref, state, 8, 0, repeats=1)
    np.testing.assert_allclose(np.asarray(result.state.pos),
                               np.asarray(ref_res.state.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(result.state.vel),
                               np.asarray(ref_res.state.vel), atol=1e-6)


def test_repack_disabled_and_lj_opt_out():
    """--grid3-repack 0 pins the whole run at the packing capacity; the LJ
    law opts out by default (its run-tail occupancy grows past the packing,
    so repacking down would immediately re-escalate)."""
    from ppsim_tpu.harness import timed_run_repeats

    state = _repack_cluster_state()
    eng = get_engine("grid3d", _repack_cfg(grid3_repack=False))
    result, _ = timed_run_repeats(eng, state, 8, 0, repeats=1, chunk_steps=2)
    assert eng.geom.capacity == 5        # no repack: packing capacity stays
    eng.check(result)

    lj = get_engine("grid3d", _repack_cfg(force_law="lj", dt=1e-4))
    lj.init_carry(state)
    assert lj.repack_plan(1000) is None  # auto: off for attractive tails


def test_sharded_grid3d_escalation_self_heals():
    """r4 verdict #6: multi-chip 3D under-capacity must heal, not fail at
    the final check. A capacity replace only changes the slab's slot
    extent (strip extents depend on ys and P, never capacity), so the
    shard_map programs re-trace cleanly at the escalated capacity."""
    import jax
    import jax.numpy as jnp

    from ppsim_tpu.engines.base import Monitors, RunResult
    from ppsim_tpu.engines.sharded_grid3d import ShardedGrid3DEngine

    cfg = SimConfig(num_parts=500, ndim=3, density=7e-6, evac_capacity=2,
                    rebin3_every=4)
    state = init_particles(cfg, seed=42, method="fast")
    eng = ShardedGrid3DEngine(cfg, devices=jax.devices()[:2])
    r1 = eng.run(state, nsteps=2)  # 2 < cadence: plain steps only (no 3D
    # rebin compile in the fast suite)
    cap1 = eng.geom.capacity

    fake = RunResult(None, None, Monitors(jnp.int32(0), jnp.int32(3),
                                          jnp.float32(0.0), jnp.int32(0)))
    assert eng.maybe_escalate_after_drop(fake)  # auto capacity: heals now
    assert eng.geom.capacity == cap1 + 1
    r2 = eng.run(state, nsteps=2)  # re-traces at the escalated capacity
    # Capacity is pure headroom: the escalated run's physics is unchanged.
    np.testing.assert_allclose(np.asarray(r1.state.pos),
                               np.asarray(r2.state.pos), atol=1e-7)
    pid_alive = int((np.asarray(r2.state.pos) != 0).any(axis=1).sum())
    assert pid_alive == cfg.num_parts


# ---------------------------------------------------------------- spill
# Deferral-style init spill (r5): the t=0 packing overflow is parked one
# bin over (inside the stale-slack envelope) instead of raising the slot
# capacity for the whole run — ops/grid3d_ops.slab3_from_particles_spill.

def _spill_cfg(**over):
    base = dict(num_parts=8, ndim=3, density=7e-6, grid3_capacity=2,
                rebin3_every=1, grid3_spill=True)
    base.update(over)
    return SimConfig(**base)


def _spill_state(face_particle=(0.0295, 0.015, 0.015)):
    """8 particles on a 2x2x2 grid (bs=0.03): three in bin (0,0,0) — one
    slot past capacity 2 — with ``face_particle`` controlling whether the
    overflow has a face within the spill depth (0.007 at cadence 1)."""
    from ppsim_tpu.state import make_state

    pos = np.array([
        [0.005, 0.005, 0.005],   # bin (0,0,0)
        [0.012, 0.012, 0.012],   # bin (0,0,0)
        list(face_particle),     # bin (0,0,0) — the packing overflow
        [0.035, 0.005, 0.005],   # bin (1,0,0): the spill target, 1 free slot
        [0.005, 0.035, 0.005],
        [0.005, 0.005, 0.035],
        [0.035, 0.035, 0.005],
        [0.035, 0.035, 0.035],
    ], np.float32)
    vel = 0.05 * np.arange(24, dtype=np.float32).reshape(8, 3) - 0.5
    return make_state(pos, vel)


def test_spill_pack_places_overflow_losslessly():
    from ppsim_tpu.engines.grid3d import Grid3DEngine
    from ppsim_tpu.ops.grid3d_ops import (
        slab3_from_particles,
        slab3_from_particles_spill,
        slab3_to_particles,
    )

    cfg = _spill_cfg()
    st = _spill_state()
    eng = Grid3DEngine(cfg)
    assert eng.capacity == 2
    _, ovf = slab3_from_particles(st.pos, st.vel, eng.geom)
    assert int(ovf) == 1  # the plain pack overflows: bin (0,0,0) holds 3

    depth = eng._spill_depth()
    assert depth > 0.0005  # the face particle sits 0.0005 from +x
    slab, ovf2, spilled = slab3_from_particles_spill(
        st.pos, st.vel, eng.geom, depth)
    assert int(ovf2) == 0
    assert int(spilled) == 1
    # Loss-free and position-exact: every particle round-trips bit-equal.
    pos2, vel2 = slab3_to_particles(slab, eng.geom, cfg.num_parts)
    np.testing.assert_array_equal(np.asarray(pos2), np.asarray(st.pos))
    np.testing.assert_array_equal(np.asarray(vel2), np.asarray(st.vel))


def test_spill_engine_keeps_capacity_and_matches_reference_forces():
    """A spilled particle resides one bin off its position's bin, within
    slack — the stencil must still see every pair. One plain step at the
    spilled capacity-2 layout must match a roomy capacity-4 engine."""
    import dataclasses

    import jax

    from ppsim_tpu.engines.grid3d import Grid3DEngine

    cfg = _spill_cfg()
    st = _spill_state()
    eng = Grid3DEngine(cfg)
    carry = eng.init_carry(st)
    assert eng.capacity == 2                   # spill kept the capacity
    assert getattr(eng, "_pack_spill", False)
    carry = jax.jit(eng.step_plain)(carry)

    ref = Grid3DEngine(dataclasses.replace(cfg, grid3_capacity=4))
    ref_carry = jax.jit(ref.step_plain)(ref.init_carry(st))
    np.testing.assert_allclose(
        np.asarray(eng.final_state_jit(carry).pos),
        np.asarray(ref.final_state_jit(ref_carry).pos), atol=1e-6)
    # Steady-state repacks (every timed repeat) reuse the spill program.
    carry2 = eng.init_carry(st)
    from ppsim_tpu.ops.grid3d_ops import slab3_to_particles
    pos2, _ = slab3_to_particles(carry2.slab, eng.geom, cfg.num_parts)
    np.testing.assert_array_equal(np.asarray(pos2), np.asarray(st.pos))


def test_spill_falls_back_to_raise_when_nothing_is_near_a_face():
    """An overflow particle at the bin center (no face within depth) must
    fall through to the measured auto-raise, loss-free."""
    from ppsim_tpu.engines.grid3d import Grid3DEngine

    st = _spill_state(face_particle=(0.015, 0.015, 0.015))
    eng = Grid3DEngine(_spill_cfg())
    eng.init_carry(st)
    assert eng.capacity == 3                  # raised to the packing
    assert not getattr(eng, "_pack_spill", False)


def test_spill_auto_gate_respects_hand_capacity():
    """grid3_spill=None (auto) only spills for auto capacity: hand
    grid3_capacity ablations must observe the raise (same contract as the
    LJ floor); grid3_spill=False disables everywhere."""
    from ppsim_tpu.engines.grid3d import Grid3DEngine

    st = _spill_state()
    hand = Grid3DEngine(_spill_cfg(grid3_spill=None))
    hand.init_carry(st)
    assert hand.capacity == 3                 # raised, not spilled
    off = Grid3DEngine(_spill_cfg(grid3_spill=False))
    off.init_carry(st)
    assert off.capacity == 3


def test_spill_pack_handles_multi_overflow_and_collisions():
    """need >= 2 spills both; a receiver without room for every donor
    leaves a nonzero overflow (graceful: the engine then raises)."""
    from ppsim_tpu.engines.grid3d import Grid3DEngine
    from ppsim_tpu.ops.grid3d_ops import (
        slab3_from_particles_spill,
        slab3_to_particles,
    )
    from ppsim_tpu.state import make_state

    cfg = _spill_cfg()
    eng = Grid3DEngine(cfg)
    depth = eng._spill_depth()

    # 4 particles in bin (0,0,0) at capacity 2, two of them within depth
    # of the +x face; receiver bin (1,0,0) empty -> both spill.
    pos = np.array([
        [0.005, 0.005, 0.005],
        [0.012, 0.012, 0.012],
        [0.0295, 0.008, 0.020],
        [0.0296, 0.020, 0.008],
        [0.005, 0.035, 0.005],
        [0.005, 0.005, 0.035],
        [0.035, 0.035, 0.005],
        [0.035, 0.035, 0.035],
    ], np.float32)
    vel = np.zeros_like(pos)
    st = make_state(pos, vel)
    slab, ovf, spilled = slab3_from_particles_spill(
        st.pos, st.vel, eng.geom, depth)
    assert int(ovf) == 0
    assert int(spilled) == 2
    pos2, _ = slab3_to_particles(slab, eng.geom, cfg.num_parts)
    np.testing.assert_array_equal(np.asarray(pos2), np.asarray(st.pos))

    # Same donors, but the receiver already holds 1 of 2 slots: pre-spill
    # eligibility sees a free slot for BOTH donors, the pack fits only
    # one extra -> overflow 1, nothing dropped silently (the caller
    # falls back to the capacity raise).
    pos_c = pos.copy()
    pos_c[4] = [0.035, 0.008, 0.008]  # occupy receiver bin (1,0,0)
    st_c = make_state(pos_c, vel)
    _, ovf_c, spilled_c = slab3_from_particles_spill(
        st_c.pos, st_c.vel, eng.geom, depth)
    assert int(ovf_c) == 1
    assert int(spilled_c) == 2  # both were reassigned; the pack caught it


def test_claim_pack3_matches_sort_including_spill():
    """rank_mode="claim" (sort-free scatter-min packing) must
    produce the same slots/overflow/spill selection; float planes may sit
    1 ulp off under XLA fusion (see the 2D twin)."""

    def slab_equiv(s_a, s_b):
        np.testing.assert_array_equal(np.asarray(s_a.pid), np.asarray(s_b.pid))
        for a, b in zip(jax.tree.leaves(s_a), jax.tree.leaves(s_b)):
            if np.asarray(a).dtype == np.int32:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            else:
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), rtol=0, atol=6e-8)
    import jax

    from ppsim_tpu.engines.grid3d import Grid3DEngine
    from ppsim_tpu.ops.grid3d_ops import (
        slab3_from_particles,
        slab3_from_particles_spill,
    )

    cfg = _spill_cfg()
    st = _spill_state()
    eng = Grid3DEngine(cfg)

    s_sort, ov_sort = slab3_from_particles(st.pos, st.vel, eng.geom, "sort")
    s_claim, ov_claim = slab3_from_particles(st.pos, st.vel, eng.geom, "claim")
    assert int(ov_sort) == int(ov_claim) == 1
    slab_equiv(s_sort, s_claim)

    depth = eng._spill_depth()
    p_sort = slab3_from_particles_spill(st.pos, st.vel, eng.geom, depth,
                                        "sort")
    p_claim = slab3_from_particles_spill(st.pos, st.vel, eng.geom, depth,
                                         "claim")
    assert int(p_sort[1]) == int(p_claim[1]) == 0
    assert int(p_sort[2]) == int(p_claim[2]) == 1
    slab_equiv(p_sort[0], p_claim[0])


def test_claim_pack3_engine_flag_plumbs_through():
    """grid_pack_mode="claim" runs the whole engine path (init spill
    included) to the same state as the default sort pack."""
    import dataclasses

    from ppsim_tpu.engines.grid3d import Grid3DEngine

    st = _spill_state()
    base = Grid3DEngine(_spill_cfg())
    claim = Grid3DEngine(
        dataclasses.replace(_spill_cfg(), grid_pack_mode="claim"))
    r0 = base.run(st, nsteps=3)
    r1 = claim.run(st, nsteps=3)
    assert claim.capacity == 2                 # spilled, not raised
    np.testing.assert_allclose(
        np.asarray(r0.state.pos), np.asarray(r1.state.pos), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(r0.state.vel), np.asarray(r1.state.vel), atol=1e-5)
