"""Lane-exact 2D geometry snap (SlabGeometry.for_config with
grid_snap_lanes): chooser invariants at the real benchmark sizes (pure
math, no device) and trajectory parity of a snapped vs default run."""

import math

import numpy as np
import pytest

from ppsim_tpu.config import SimConfig
from ppsim_tpu.engines import get_engine
from ppsim_tpu.initlib import init_particles
from ppsim_tpu.ops.grid_ops import _GEOM_VMAX, SlabGeometry


def _cost(cfg, g):
    from ppsim_tpu.ops.grid_ops import _GEOM_COST_A, _GEOM_COST_B

    occ = cfg.num_parts / (g.rows * g.cols)
    pad = (g.rows_pad * g.cols_pad) / (g.rows * g.cols)
    planes = g.capacity * (g.capacity - 1) / 2 + 4 * g.capacity**2
    return (_GEOM_COST_A * planes + _GEOM_COST_B * g.capacity) / occ * pad


@pytest.mark.parametrize("n", [1_048_576, 4_194_304, 16_384_000, 20_971_520])
def test_snap_chooser_invariants(n):
    from ppsim_tpu.ops.grid_ops import _GEOM_FREE_MARGIN, GRID_CAPACITY_DEFAULT

    cfg = SimConfig(num_parts=n, grid_snap_lanes=True)
    g = SlabGeometry.for_config(cfg)
    g0 = SlabGeometry.for_config(cfg.with_(grid_snap_lanes=False))
    # Never worse than the default under the model (within the tie-break
    # epsilon), and physically sound.
    assert _cost(cfg, g) <= _cost(cfg, g0) * 1.0101
    assert g.rows == g.cols
    if g.rows != g0.rows:  # a snapped candidate won
        assert g.rows % 128 == 0  # exact cover: zero padded rows/cols
        assert g.rows_pad == g.rows and g.cols_pad == g.cols
        occ = n / (g.rows * g.cols)
        headroom = GRID_CAPACITY_DEFAULT - math.ceil(n / (g0.rows * g0.cols))
        assert g.capacity == math.ceil(occ + _GEOM_FREE_MARGIN) + headroom
        # Deferral-pressure guard: free slack strictly above the measured
        # failure cliff (free == headroom dropped particles at 16.38M).
        assert g.capacity - occ >= headroom + _GEOM_FREE_MARGIN
    # Slack feasibility at the assumed vmax (the gate for_config enforces).
    slack = (g.bin_size - cfg.cutoff) / 2.0
    assert cfg.rebin_every * _GEOM_VMAX * cfg.dt <= slack + 1e-12
    # The grid still covers the box.
    assert g.rows * g.bin_size >= cfg.size


def test_snap_chooser_picks_are_the_validated_winners():
    """Regression pin: the chooser must reproduce the validated picks of
    the recorded geometry runs. In particular the near-tie at 20.97M must
    break toward the cap-14 pick (0 dropped), not the model's 0.7%-cheaper
    cap-17 shape, and the two shapes that DROPPED particles (16.38M
    1280^2/cap16, 20.97M 1536^2/cap15) must never be chosen."""
    expect = {
        1_048_576: (384, 14),
        4_194_304: (640, 17),
        16_384_000: (1408, 15),
        20_971_520: (1664, 14),
    }
    for n, (m, cap) in expect.items():
        g = SlabGeometry.for_config(SimConfig(num_parts=n, grid_snap_lanes=True))
        assert (g.rows, g.capacity) == (m, cap), (n, g.rows, g.capacity)


def test_snap_noop_on_small_and_exact_grids():
    # Tiny test grids (<= one lane tile) never snap.
    small = SimConfig(num_parts=2000, grid_snap_lanes=True)
    assert SlabGeometry.for_config(small) == SlabGeometry.for_config(
        small.with_(grid_snap_lanes=False)
    )
    # 20.97M is the exactly-aligned headline grid (2048^2): if the chooser
    # moves off it, it must be to another exact-cover geometry, never to a
    # padded one.
    head = SimConfig(num_parts=20_971_520, grid_snap_lanes=True)
    g = SlabGeometry.for_config(head)
    assert g.rows_pad == g.rows and g.cols_pad == g.cols


def test_snap_run_matches_default_geometry():
    """Same physics through a snapped grid: the chooser picks m=128 (exact
    cover, occupancy ~4) over the default 144-bin grid (cols padded 1.78x)
    at this size/scale; trajectories must agree to f32 summation-order
    tolerance and all monitors must stay clean."""
    cfg = SimConfig(num_parts=65_536, grid_bin_scale=4.0, grid_capacity=10,
                    rebin_every=4, grid_snap_lanes=True)
    g = SlabGeometry.for_config(cfg)
    assert g.rows == 128 and g.rows_pad == 128 and g.cols_pad == 128
    st = init_particles(cfg, seed=42, method="fast")
    eng = get_engine("grid", cfg)
    r1 = eng.run(st, nsteps=12)
    eng.check(r1)
    e0 = get_engine("grid", cfg.with_(grid_snap_lanes=False))
    assert e0.geom.rows == 144
    r0 = e0.run(st, nsteps=12)
    e0.check(r0)
    np.testing.assert_allclose(
        np.asarray(r1.state.pos), np.asarray(r0.state.pos), atol=5e-6
    )
