"""2-D tile-mesh engine: parity with the single-chip grid engine and
cross-tile migration invariants (both mesh axes) on the 8-device CPU mesh."""

import dataclasses

import jax
import numpy as np
import pytest

from ppsim_tpu.engines import get_engine
from ppsim_tpu.engines.sharded_tile import ShardedTileEngine, _mesh_factor
from ppsim_tpu.initlib import init_particles


def test_mesh_factor_near_square_rows_heavy():
    assert _mesh_factor(1) == (1, 1)
    assert _mesh_factor(4) == (2, 2)
    assert _mesh_factor(6) == (3, 2)
    assert _mesh_factor(8) == (4, 2)
    assert _mesh_factor(7) == (7, 1)


def test_sharded_tile_matches_grid_2x2(grid_test_config):
    """Forces and rebins across BOTH tile boundaries (incl. the corner where
    four tiles meet) must reproduce the single-chip engine."""
    cfg = grid_test_config
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=16)
    r2 = ShardedTileEngine(cfg, devices=jax.devices()[:4],
                           col_block=8).run(st, nsteps=16)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=2e-6
    )
    assert int(r2.monitors.migrate_dropped) == 0


def test_sharded_tile_dirs9_mode_matches_grid(tiny_grid_config):
    """The 9-direction rebin factorization through the 2-ghost-ring tile
    extension (diagonal movers cross a corner in ONE hop here, unlike the
    axes mode's two single-axis hops)."""
    cfg = dataclasses.replace(tiny_grid_config, grid_rebin_mode="dirs9")
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=12)
    r2 = ShardedTileEngine(cfg, devices=jax.devices()[:4],
                           col_block=8).run(st, nsteps=12)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=2e-6
    )
    r2.check(cfg, capacity=cfg.grid_capacity)


def test_sharded_tile_pallas_col_split_matches_grid(grid_test_config):
    """Pure col-axis split (1x4): every cross-boundary pair and every
    lateral/corner migration crosses a col boundary (no row split to mask a
    col bug); the engine must reproduce the single-device engine."""
    cfg = grid_test_config
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=16)
    r2 = ShardedTileEngine(cfg, devices=jax.devices()[:4],
                           mesh_shape=(1, 4), col_block=8).run(st, nsteps=16)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=2e-6,
    )
    assert int(r2.monitors.migrate_dropped) == 0


def test_sharded_tile_saved_run_matches_grid(tiny_grid_config):
    cfg = tiny_grid_config
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=12, savefreq=4)
    r2 = ShardedTileEngine(cfg, devices=jax.devices()[:4],
                           col_block=8).run(st, nsteps=12, savefreq=4)
    assert r1.frames.shape == r2.frames.shape == (3, cfg.num_parts, 2)
    np.testing.assert_allclose(r1.frames, r2.frames, atol=2e-6)


@pytest.mark.slow
def test_sharded_tile_8dev_matches_grid(grid_test_config):
    """Default mesh factorization over all 8 devices: (4, 2)."""
    cfg = grid_test_config
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=16)
    eng = get_engine("sharded_tile", cfg)
    assert (eng.Pr, eng.Pc) == (4, 2)
    r2 = eng.run(st, nsteps=16)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=2e-6
    )


@pytest.mark.slow
def test_sharded_tile_conserves_particles_long_run(grid_test_config):
    """Many rebin rounds with hops across row, col, and corner boundaries;
    every particle stays accounted for exactly once."""
    cfg = grid_test_config
    st = init_particles(cfg, seed=7, method="fast")
    eng = ShardedTileEngine(cfg, devices=jax.devices()[:4], col_block=8)
    res = eng.run(st, nsteps=120)
    eng.check(res)
    pos = np.asarray(res.state.pos)
    assert pos.shape[0] == cfg.num_parts
    assert int(res.monitors.migrate_dropped) == 0
    assert pos.min() >= 0.0 and pos.max() <= cfg.size
