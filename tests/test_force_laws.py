"""Force-law plug-in seam: truncated Lennard-Jones through the same engines."""

import numpy as np
import pytest

from ppsim_tpu.config import SimConfig
from ppsim_tpu.engines import get_engine
from ppsim_tpu.initlib import init_particles
from ppsim_tpu.physics import lj_accel_from_deltas


def test_lj_law_shape_and_sign():
    import jax.numpy as jnp

    sigma, eps = 0.007, 1e-4
    r_min = 2 ** (1 / 6) * sigma
    # closer than the potential minimum: repulsive (+x force on i at origin
    # means coef*dx < 0 when neighbor is at +dx... a_i points away from j)
    ax, _ = lj_accel_from_deltas(jnp.float32(0.8 * r_min), jnp.float32(0.0),
                                 0.01, 1e-4, 0.01, eps, sigma)
    assert float(ax) < 0  # pushed away from the neighbor at +x
    # farther than the minimum but inside cutoff: attractive
    # (with sigma=0.007, r_min=0.0079 and cutoff=0.01 the window is narrow)
    ax, _ = lj_accel_from_deltas(jnp.float32(1.2 * r_min), jnp.float32(0.0),
                                 0.01, 1e-4, 0.01, eps, sigma)
    assert float(ax) > 0
    # outside cutoff: zero
    ax, _ = lj_accel_from_deltas(jnp.float32(0.02), jnp.float32(0.0),
                                 0.01, 1e-4, 0.01, eps, sigma)
    assert float(ax) == 0.0


def test_lj_binned_matches_oracle():
    cfg = SimConfig(num_parts=600, force_law="lj")
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("oracle", cfg).run(st, nsteps=50, savefreq=10)
    r2 = get_engine("binned", cfg).run(st, nsteps=50, savefreq=10)
    np.testing.assert_array_equal(r1.frames, r2.frames)


def test_lj_grid_close_to_oracle(grid_test_config):
    cfg = grid_test_config.with_(force_law="lj")
    st = init_particles(cfg, seed=42, method="reference")
    s1 = get_engine("oracle", cfg).step_state(st)
    s2 = get_engine("grid", cfg).step_state(st)
    np.testing.assert_allclose(np.asarray(s1.pos), np.asarray(s2.pos), atol=5e-7)


def test_lj_dynamics_bounded():
    # LJ's r^-12 wall needs a smaller dt than the repulsive default.
    cfg = SimConfig(num_parts=400, force_law="lj", dt=1e-4)
    st = init_particles(cfg, seed=7, method="fast")
    res = get_engine("binned", cfg).run(st, nsteps=200)
    pos = np.asarray(res.state.pos)
    vel = np.asarray(res.state.vel)
    assert pos.min() >= 0 and pos.max() <= cfg.size
    assert np.abs(vel).max() < 10.0


def test_lj_pallas_interpret_matches_grid(tiny_grid_config):
    """The force-law seam extends through the Triton kernel: LJ in
    ops/pallas_grid._pair_coef against the XLA twin (interpret mode)."""
    cfg = tiny_grid_config.with_(force_law="lj", dt=1e-4)
    st = init_particles(cfg, seed=42, method="reference")
    s1 = get_engine("grid", cfg).step_state(st)
    s2 = get_engine("pallas", cfg, interpret=True).step_state(st)
    np.testing.assert_allclose(np.asarray(s1.pos), np.asarray(s2.pos), atol=1e-7)


def test_lj_sharded_grid_two_device(tiny_grid_config):
    """LJ through the sharded flagship: 2-device strips + halo + rebin."""
    import jax

    from ppsim_tpu.engines.sharded_grid import ShardedGridEngine

    cfg = tiny_grid_config.with_(force_law="lj", dt=1e-4)
    st = init_particles(cfg, seed=42, method="reference")
    r1 = get_engine("grid", cfg).run(st, nsteps=8)
    r2 = ShardedGridEngine(cfg, devices=jax.devices()[:2],
                           interpret=True).run(st, nsteps=8)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r2.state.pos), atol=2e-6
    )
    assert int(r2.monitors.migrate_dropped) == 0


def test_unknown_force_law_rejected():
    with pytest.raises(ValueError, match="unknown force_law"):
        SimConfig(num_parts=100, force_law="coulomb").validate()
