"""Sharded slab-grid engine: parity with the single-chip engine and
cross-shard migration invariants on the 8-device CPU mesh."""

import numpy as np
import pytest

from ppsim_tpu.engines import get_engine
from ppsim_tpu.initlib import init_particles


@pytest.mark.slow
def test_sharded_grid_matches_grid(grid_test_config):
    cfg = grid_test_config
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=24)
    r2 = get_engine("sharded_grid", cfg, interpret=True).run(st, nsteps=24)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=2e-6
    )
    assert int(r2.monitors.migrate_dropped) == 0


def test_sharded_grid_saved_run_matches_grid(tiny_grid_config):
    """run(savefreq>0) on the sharded flagship: the statically-scheduled
    save driver (GridEngine._run_impl) must reproduce the single-chip frames
    (round-1 verdict: this path was never executed)."""
    import jax

    from ppsim_tpu.engines.sharded_grid import ShardedGridEngine

    cfg = tiny_grid_config
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=12, savefreq=4)
    r2 = ShardedGridEngine(cfg, devices=jax.devices()[:2],
                           interpret=True).run(st, nsteps=12, savefreq=4)
    assert r1.frames.shape == r2.frames.shape == (3, cfg.num_parts, 2)
    np.testing.assert_allclose(r1.frames, r2.frames, atol=2e-6)


def test_sharded_grid_xla_impl_matches_grid(grid_test_config):
    """The XLA-twin impl (ghost-row extension + single-chip twin ops per
    shard) must track the single-chip grid engine through rebins with
    cross-shard migration. This impl is what CPU-mesh scaling benchmarks
    run (the interpreted kernel is far too slow at benchmark sizes)."""
    import jax

    from ppsim_tpu.engines.sharded_grid import ShardedGridEngine

    cfg = grid_test_config
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=16)
    r2 = ShardedGridEngine(cfg, devices=jax.devices()[:4], impl="xla").run(
        st, nsteps=16
    )
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=2e-6
    )
    assert int(r2.monitors.migrate_dropped) == 0


def test_grid_saved_and_unsaved_runs_agree(tiny_grid_config):
    """Saving must not change the dynamics: the save driver runs the exact
    same step sequence as the benchmark driver, so final states match
    bit-for-bit."""
    cfg = tiny_grid_config
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=8, savefreq=0)
    r2 = get_engine("grid", cfg).run(st, nsteps=8, savefreq=4)
    np.testing.assert_array_equal(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos)
    )


@pytest.mark.slow
def test_sharded_grid_conserves_particles_long_run(grid_test_config):
    """Cross-shard transfers ride the rebin shuffle; over many rebins every
    particle must stay accounted for exactly once."""
    cfg = grid_test_config
    st = init_particles(cfg, seed=7, method="fast")
    eng = get_engine("sharded_grid", cfg, interpret=True)
    res = eng.run(st, nsteps=120)
    eng.check(res)
    pos = np.asarray(res.state.pos)
    assert pos.shape[0] == cfg.num_parts
    # final_state scatters by pid: any lost particle leaves a zero row AND
    # drops the alive count; monitors.migrate_dropped == 0 already guards
    # loss, this checks the id-space is fully covered too.
    assert int(res.monitors.migrate_dropped) == 0
    assert pos.min() >= 0.0 and pos.max() <= cfg.size


def test_chunked_saved_run_matches_unchunked(tiny_grid_config):
    """Large saved runs auto-chunk (frames stream to host between compiled
    phase-aligned slices — the 20M ``-o`` run would otherwise accumulate
    ~16 GB of frames in HBM). Chunked and unchunked runs must agree
    bit-for-bit, including the cadence phase across chunk boundaries."""
    cfg = tiny_grid_config
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=23, savefreq=3)
    r2 = get_engine("grid", cfg).run(
        st, nsteps=23, savefreq=3,
        max_device_frame_bytes=cfg.num_parts * 2 * 4,  # ~1 frame per chunk
    )
    np.testing.assert_array_equal(r1.frames, r2.frames)
    np.testing.assert_array_equal(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos)
    )


def test_sharded_grid_axes_mode_matches_grid(tiny_grid_config):
    """grid_rebin_mode='axes' across strips: both impls (XLA extension and
    the Triton step kernel with ghost rows) must track the single-chip axes
    engine through rebins, with identical monitors."""
    import dataclasses

    import jax

    from ppsim_tpu.engines.sharded_grid import ShardedGridEngine

    cfg = dataclasses.replace(tiny_grid_config, grid_rebin_mode="axes")
    st = init_particles(cfg, seed=42, method="reference")
    ref = get_engine("grid", cfg).run(st, nsteps=12, savefreq=0)
    for impl in ("xla", "pallas"):
        res = ShardedGridEngine(cfg, devices=jax.devices()[:2], impl=impl,
                                interpret=True).run(st, nsteps=12, savefreq=0)
        np.testing.assert_allclose(
            np.asarray(ref.state.pos), np.asarray(res.state.pos), atol=2e-6,
            err_msg=impl,
        )
        res.check(cfg, capacity=cfg.grid_capacity)
        assert int(res.monitors.migrate_dropped) == 0, impl


@pytest.mark.slow
def test_sharded_grid_axes_conserves_particles_long_run(grid_test_config):
    """Axes-mode twin of the long-run conservation test: many rebin rounds
    with cross-strip hops, nothing lost or duplicated."""
    import dataclasses

    cfg = dataclasses.replace(grid_test_config, grid_rebin_mode="axes")
    st = init_particles(cfg, seed=7, method="fast")
    eng = get_engine("sharded_grid", cfg, interpret=True)
    res = eng.run(st, nsteps=120)
    eng.check(res)
    pos = np.asarray(res.state.pos)
    assert pos.shape[0] == cfg.num_parts
    assert int(res.monitors.migrate_dropped) == 0
    assert pos.min() >= 0.0 and pos.max() <= cfg.size
