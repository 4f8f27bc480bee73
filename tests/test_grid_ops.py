"""Slab-grid op invariants: packing roundtrip, rebin conservation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppsim_tpu.config import SimConfig
from ppsim_tpu.initlib import init_particles
from ppsim_tpu.ops import grid_ops
from ppsim_tpu.ops.binning import BIG
from ppsim_tpu.ops.grid_ops import SlabGeometry


@pytest.fixture
def geom(grid_test_config):
    return SlabGeometry.for_config(grid_test_config)


def pack(cfg, geom, seed=42):
    state = init_particles(cfg, seed=seed, method="fast")
    slab, overflow = jax.jit(lambda p, v: grid_ops.slab_from_particles(p, v, geom))(
        state.pos, state.vel
    )
    assert int(overflow) == 0
    return state, slab


def test_pack_unpack_roundtrip(grid_test_config, geom):
    cfg = grid_test_config
    state, slab = pack(cfg, geom)
    pos, vel = grid_ops.slab_to_particles(slab, geom, cfg.num_parts)
    np.testing.assert_allclose(np.asarray(pos), np.asarray(state.pos), atol=2e-6)
    np.testing.assert_array_equal(np.asarray(vel), np.asarray(state.vel))


def test_pack_bin_locality(grid_test_config, geom):
    _, slab = pack(grid_test_config, geom)
    xl = np.asarray(slab.xl)
    occupied = np.asarray(slab.pid) >= 0
    assert xl[occupied].min() >= 0.0
    assert xl[occupied].max() <= geom.bin_size + 1e-6
    assert (xl[~occupied] == BIG).all()


def test_rebin_identity_when_nothing_moved(grid_test_config, geom):
    cfg = grid_test_config
    _, slab = pack(cfg, geom)
    new, mon = jax.jit(lambda s: grid_ops.grid_rebin(s, geom, cfg.evac_capacity))(slab)
    assert int(mon.dropped) == 0
    np.testing.assert_array_equal(np.asarray(new.pid), np.asarray(slab.pid))
    np.testing.assert_array_equal(np.asarray(new.xl), np.asarray(slab.xl))


def test_rebin_conserves_particles_after_drift(grid_test_config, geom):
    cfg = grid_test_config
    state, slab = pack(cfg, geom)
    # Drift every particle by a sizeable step so some cross bin boundaries.
    rng = np.random.default_rng(0)
    drift = rng.uniform(-0.4 * geom.bin_size, 0.4 * geom.bin_size, (2,))
    alive = slab.pid >= 0
    slab = slab._replace(
        xl=jnp.where(alive, slab.xl + drift[0], slab.xl),
        yl=jnp.where(alive, slab.yl + drift[1], slab.yl),
    )
    new, mon = jax.jit(lambda s: grid_ops.grid_rebin(s, geom, cfg.evac_capacity))(slab)
    assert int(mon.dropped) == 0

    old_pids = np.sort(np.asarray(slab.pid)[np.asarray(slab.pid) >= 0])
    new_pids = np.sort(np.asarray(new.pid)[np.asarray(new.pid) >= 0])
    np.testing.assert_array_equal(old_pids, new_pids)

    # Global positions unchanged by rebinning (renorm is exact).
    def gpos(s):
        gx, gy = grid_ops.global_positions(s, geom)
        flat = np.asarray(s.pid).reshape(-1)
        out = np.zeros((cfg.num_parts, 2))
        ok = flat >= 0
        out[flat[ok], 0] = np.asarray(gx).reshape(-1)[ok]
        out[flat[ok], 1] = np.asarray(gy).reshape(-1)[ok]
        return out

    np.testing.assert_allclose(gpos(new), gpos(slab), atol=1e-6)
    # Rebinned positions are back inside their bins.
    occ = np.asarray(new.pid) >= 0
    assert np.asarray(new.xl)[occ].min() >= -1e-6
    assert np.asarray(new.xl)[occ].max() <= geom.bin_size + 1e-6


def test_move_keeps_empty_slots_inert(grid_test_config, geom):
    cfg = grid_test_config
    _, slab = pack(cfg, geom)
    accel = (jnp.ones_like(slab.xl), jnp.ones_like(slab.yl))
    new, max_speed = jax.jit(
        lambda s: grid_ops.grid_move(s, accel, geom, cfg.dt, cfg.size)
    )(slab)
    empty = np.asarray(slab.pid) < 0
    assert (np.asarray(new.xl)[empty] == BIG).all()
    assert float(max_speed) > 0


def test_rebin_defers_instead_of_dropping(grid_test_config, geom):
    """Overfull destination: entrants beyond the free-slot budget must stay
    in their source bins (deferred), never vanish (the reference's CUDA
    engine silently corrupts here, gpu.cu:109-111)."""
    cfg = grid_test_config
    cap = geom.capacity
    # Two adjacent bins: left full with movers-right, right completely full.
    xl = np.full(geom.shape, grid_ops.BIG if hasattr(grid_ops, "BIG") else 1e9,
                 dtype=np.float32)
    from ppsim_tpu.ops.binning import BIG as BIGC

    xl = np.full(geom.shape, BIGC, dtype=np.float32)
    yl = np.full(geom.shape, BIGC, dtype=np.float32)
    vx = np.zeros(geom.shape, np.float32)
    vy = np.zeros(geom.shape, np.float32)
    pid = np.full(geom.shape, -1, np.int32)
    r, c = 3, 3
    for s in range(cap):
        # left bin residents all drifted one bin to the right (+x row dir)
        pid[s, r, c] = s
        xl[s, r, c] = geom.bin_size * 1.25
        yl[s, r, c] = geom.bin_size * 0.5
        # right bin full of stayers
        pid[s, r + 1, c] = cap + s
        xl[s, r + 1, c] = geom.bin_size * 0.5
        yl[s, r + 1, c] = geom.bin_size * 0.5
    state = grid_ops.SlabState(*map(jnp.asarray, (xl, yl, vx, vy, pid)))
    new, mon = jax.jit(lambda s: grid_ops.grid_rebin(s, geom, cfg.evac_capacity))(state)
    assert int(mon.dropped) == 0
    assert int(mon.deferred) == cap  # nobody fits; all wait in place
    old_pids = np.sort(np.asarray(state.pid)[np.asarray(state.pid) >= 0])
    new_pids = np.sort(np.asarray(new.pid)[np.asarray(new.pid) >= 0])
    np.testing.assert_array_equal(old_pids, new_pids)


# ------------------------------------------------- axis-factorized rebin
def _stress_slab(geom, seed=0, far_movers=0):
    """Random near-capacity slab with drifted locals (dirs in {-1,0,1}) —
    heavy acceptance contention on purpose."""
    from ppsim_tpu.ops.binning import BIG as BIGC

    rng = np.random.default_rng(seed)
    cap = geom.capacity
    R, C = geom.rows_pad, geom.cols_pad
    occ = rng.integers(0, cap + 1, size=(R, C))
    occ[geom.rows:, :] = 0
    occ[:, geom.cols:] = 0
    xl = np.full((cap, R, C), BIGC, np.float32)
    yl = np.full((cap, R, C), BIGC, np.float32)
    vx = np.zeros((cap, R, C), np.float32)
    vy = np.zeros((cap, R, C), np.float32)
    pid = np.full((cap, R, C), -1, np.int32)
    k = 0
    bs = geom.bin_size
    for r in range(geom.rows):
        for c in range(geom.cols):
            for s in range(occ[r, c]):
                xl[s, r, c] = rng.uniform(-bs, 2 * bs)
                yl[s, r, c] = rng.uniform(-bs, 2 * bs)
                vx[s, r, c] = rng.normal()
                vy[s, r, c] = rng.normal()
                pid[s, r, c] = k
                k += 1
    for i in range(far_movers):
        r, c = 2 + i, 2
        if pid[0, r, c] < 0:
            pid[0, r, c] = k
            k += 1
        xl[0, r, c] = 2.2 * bs  # raw row dir = 2: a stale-slack violation
        yl[0, r, c] = 0.5 * bs
    return grid_ops.SlabState(*map(jnp.asarray, (xl, yl, vx, vy, pid))), k


def _canon(s, geom, n):
    gx, gy = grid_ops.global_positions(s, geom)
    pid = np.asarray(s.pid).reshape(-1)
    ok = pid >= 0
    out = np.zeros((n, 4))
    out[pid[ok], 0] = np.asarray(gx).reshape(-1)[ok]
    out[pid[ok], 1] = np.asarray(gy).reshape(-1)[ok]
    out[pid[ok], 2] = np.asarray(s.vx).reshape(-1)[ok]
    out[pid[ok], 3] = np.asarray(s.vy).reshape(-1)[ok]
    return out, int(ok.sum())


def test_rebin_variants_agree_on_global_positions():
    """dirs9 and axes make different deferral choices but both are loss-free
    and relocate storage only: per-pid global state must agree to f32
    reconstruction rounding."""
    geom = SlabGeometry(rows=13, cols=100, rows_pad=16, cols_pad=128,
                        capacity=4, bin_size=0.05)
    slab, n = _stress_slab(geom, seed=1)
    a, ma = jax.jit(lambda s: grid_ops.grid_rebin(s, geom, 2))(slab)
    b, mb = jax.jit(lambda s: grid_ops.grid_rebin_axes(s, geom, 2))(slab)
    ca, na = _canon(a, geom, n)
    cb, nb = _canon(b, geom, n)
    assert na == nb == n
    np.testing.assert_allclose(ca, cb, atol=1e-6)
    assert int(ma.dropped) == int(mb.dropped) == 0
    assert int(ma.max_occupancy) <= geom.capacity
    assert int(mb.max_occupancy) <= geom.capacity


def test_far_mover_flagged_pre_rebin_all_variants():
    """A 2-bin drifter is a stale-slack violation; every rebin variant must
    count it into the fatal ``dropped`` monitor from the PRE-rebin state
    (post-rebin it looks like a benign 1-bin mover — the silent-absorption
    bug class fixed in grid3_rebin_axes in round 3)."""
    geom = SlabGeometry(rows=13, cols=100, rows_pad=16, cols_pad=128,
                        capacity=4, bin_size=0.05)
    slab, _ = _stress_slab(geom, seed=2, far_movers=1)
    variants = {
        "xla_dirs9": lambda s: grid_ops.grid_rebin(s, geom, 2),
        "xla_axes": lambda s: grid_ops.grid_rebin_axes(s, geom, 2),
    }
    for name, fn in variants.items():
        _, mon = jax.jit(fn)(slab)
        assert int(mon.dropped) == 1, name


def test_axes_rebin_defers_instead_of_dropping(grid_test_config, geom):
    """Axes twin of test_rebin_defers_instead_of_dropping: an overfull
    destination defers entrants in place, never drops them."""
    from ppsim_tpu.ops.binning import BIG as BIGC

    cfg = grid_test_config
    cap = geom.capacity
    xl = np.full(geom.shape, BIGC, dtype=np.float32)
    yl = np.full(geom.shape, BIGC, dtype=np.float32)
    vx = np.zeros(geom.shape, np.float32)
    vy = np.zeros(geom.shape, np.float32)
    pid = np.full(geom.shape, -1, np.int32)
    r, c = 3, 3
    for s in range(cap):
        pid[s, r, c] = s
        xl[s, r, c] = geom.bin_size * 1.25
        yl[s, r, c] = geom.bin_size * 0.5
        pid[s, r + 1, c] = cap + s
        xl[s, r + 1, c] = geom.bin_size * 0.5
        yl[s, r + 1, c] = geom.bin_size * 0.5
    state = grid_ops.SlabState(*map(jnp.asarray, (xl, yl, vx, vy, pid)))
    new, mon = jax.jit(
        lambda s: grid_ops.grid_rebin_axes(s, geom, cfg.evac_capacity)
    )(state)
    assert int(mon.dropped) == 0
    assert int(mon.deferred) == cap
    old_pids = np.sort(np.asarray(state.pid)[np.asarray(state.pid) >= 0])
    new_pids = np.sort(np.asarray(new.pid)[np.asarray(new.pid) >= 0])
    np.testing.assert_array_equal(old_pids, new_pids)


# ------------------------------------------------------------- claim pack
# Sort-free packing (binning.claim_ranks): an n-sort-free alternative to
# the argsort pack, with every n-sized scatter chunked. The claim
# pack assigns the IDENTICAL (bin, slot) to every particle; the bin-local
# coordinates can sit 1 ulp off (XLA fuses the `pos - bin*bs` subtract
# differently in the two graphs), which is far inside every engine-twin
# tolerance in this suite.


def _assert_slab_equiv(s_a, s_b):
    """Same slots and ids exactly; float planes to 1 ulp."""
    np.testing.assert_array_equal(np.asarray(s_a.pid), np.asarray(s_b.pid))
    for a, b in zip(jax.tree.leaves(s_a), jax.tree.leaves(s_b)):
        if np.asarray(a).dtype == np.int32:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=0, atol=6e-8)

def test_claim_pack_matches_sort_pack(grid_test_config, geom):
    cfg = grid_test_config
    state = init_particles(cfg, seed=7, method="fast")
    s_sort, ov_sort = jax.jit(
        lambda p, v: grid_ops.slab_from_particles(p, v, geom, "sort")
    )(state.pos, state.vel)
    s_claim, ov_claim = jax.jit(
        lambda p, v: grid_ops.slab_from_particles(p, v, geom, "claim")
    )(state.pos, state.vel)
    _assert_slab_equiv(s_sort, s_claim)
    assert int(ov_sort) == int(ov_claim) == 0


def test_claim_pack_overflow_parity():
    """An over-capacity bin drops the SAME particles (stable-rank order:
    lowest original indices survive) and reports the same overflow."""
    cfg = SimConfig(num_parts=6, grid_capacity=2, grid_bin_scale=3.0)
    geom = SlabGeometry.for_config(cfg)
    bs = geom.bin_size
    pos = jnp.asarray(np.array([
        [0.1 * bs, 0.1 * bs],   # all four in bin (0, 0): 2 past capacity
        [0.2 * bs, 0.2 * bs],
        [0.3 * bs, 0.3 * bs],
        [0.4 * bs, 0.4 * bs],
        [1.5 * bs, 0.5 * bs],
        [0.5 * bs, 1.5 * bs],
    ], np.float32))
    vel = jnp.asarray(np.arange(12, dtype=np.float32).reshape(6, 2))
    s_sort, ov_sort = grid_ops.slab_from_particles(pos, vel, geom, "sort")
    s_claim, ov_claim = grid_ops.slab_from_particles(pos, vel, geom, "claim")
    assert int(ov_sort) == int(ov_claim) == 2
    _assert_slab_equiv(s_sort, s_claim)
    kept = np.asarray(s_sort.pid)[np.asarray(s_sort.pid) >= 0]
    assert set(kept) == {0, 1, 4, 5}


def test_engine_grid_pack_mode_claim_matches_default(grid_test_config):
    import dataclasses

    from ppsim_tpu.engines import get_engine

    state = init_particles(grid_test_config, seed=3, method="fast")
    base = get_engine("grid", grid_test_config)
    claim = get_engine(
        "grid", dataclasses.replace(grid_test_config, grid_pack_mode="claim"))
    r0 = base.run(state, nsteps=5)
    r1 = claim.run(state, nsteps=5)
    np.testing.assert_allclose(
        np.asarray(r0.state.pos), np.asarray(r1.state.pos), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(r0.state.vel), np.asarray(r1.state.vel), atol=1e-5)


def test_chunked_scatter_matches_single_scatter():
    """set/min/add over chunk boundaries must equal the one-shot scatter
    (the compile-safe pack bounds every scatter's sorted-scatter temp —
    binning.SCATTER_CHUNK; chunk=3 here forces many chunks)."""
    from ppsim_tpu.ops.binning import chunked_scatter

    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, 7, size=(17,)), jnp.int32)
    vals = jnp.asarray(rng.normal(size=(17,)).astype(np.float32))
    base = jnp.full((7,), 100.0, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(chunked_scatter(base, idx, vals, "min", chunk=3)),
        np.asarray(base.at[idx].min(vals, mode="drop")))
    np.testing.assert_array_equal(
        np.asarray(chunked_scatter(jnp.zeros((7,), jnp.float32), idx, vals,
                                   "add", chunk=3)),
        np.asarray(jnp.zeros((7,), jnp.float32).at[idx].add(vals,
                                                           mode="drop")))
    # set with UNIQUE indices (the pack's case): order can't matter.
    uidx = jnp.asarray(rng.permutation(17)[:17], jnp.int32)
    tgt = jnp.full((17,), -1.0, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(chunked_scatter(tgt, uidx, vals, "set", chunk=5)),
        np.asarray(tgt.at[uidx].set(vals, mode="drop")))


def test_slab_to_particles_chunked_bit_identical(grid_test_config, geom):
    cfg = grid_test_config
    _, slab = pack(cfg, geom)
    import ppsim_tpu.ops.binning as binning
    p0, v0 = grid_ops.slab_to_particles(slab, geom, cfg.num_parts)
    old = binning.SCATTER_CHUNK
    binning.SCATTER_CHUNK = 257  # force many ragged chunks
    try:
        p1, v1 = grid_ops.slab_to_particles(slab, geom, cfg.num_parts,
                                            chunked=True)
    finally:
        binning.SCATTER_CHUNK = old
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
