"""Dense 3D slab-grid: the stretch-config state layout.

The reference is strictly 2D; the declared stretch config (BASELINE.json
configs[4]) is a 3D Lennard-Jones variant with neighbor lists at n=20M. This
module generalizes the 2D slab grid (ops/grid_ops.py) to three dimensions:

- Fields ``xl, yl, zl, vx, vy, vz`` are laid out ``(capacity, Y, X, Z)``:
  one (X, Z) plane per (slot, y-slab), X padded to a multiple of 8 and Z to
  a multiple of 128 (a padding rule chosen for another machine and awaiting
  a refit on the GPU), and **y is the outer blocked axis** — the sharded
  decomposition strips over y exactly like the 2D strip-over-x (the
  reference's MPI rows, part2/mpi.cpp:258-294).
- The 3x3x3 stencil is 27 dense shifted planes with physical-edge masks.
  No gathers, no atomics — the 2D design's invariants (BIG-sentinel empty
  slots, bin-local coordinates, lazy rebin cadence with monitored slack)
  carry over unchanged.
- The 27-direction loss-free rebin shuffle reuses the 2D acceptance design
  (destination-budget acceptance from shared count planes, deterministic
  global priority, rejected leavers defer) — see grid_ops.grid_rebin's
  docstring for the contract.

The capacity-padded cell slots rebuilt on the rebin cadence ARE the 3D
neighbor list (a cell-granular Verlet list with static shapes), the same
claim as engines/binned3d.py but in the dense flagship layout.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ppsim_tpu.ops.binning import BIG
from ppsim_tpu.ops.grid_ops import RebinMonitors

__all__ = [
    "Geometry3S",
    "Slab3State",
    "DIRS3",
    "slab3_from_particles",
    "slab3_to_particles",
    "grid3_force_xla",
    "grid3_move",
]

# Direction codes: d = ((dy+1)*3 + (dx+1))*3 + (dz+1); 13 = stay.
DIRS3 = [
    (dy, dx, dz)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    for dz in (-1, 0, 1)
]
STAY3 = 13


# Cost of one rebin relative to one force step at equal padded volume,
# fitted on another machine and awaiting a refit on the GPU (ROADMAP C4).
# Used only to rank candidate geometries against their rebin cadence in
# for_config.
_REBIN_COST_FACTOR = 0.42

# Auto slot capacity (config.grid3_capacity = None). Base 10 is the r1-r3
# default, measured safe for the repulsive law at every benchmark size
# (run max never exceeds the initial lattice packing there; engines/
# grid3d.py auto-raises on packing overflow). The attractive LJ tail is
# different in kind: condensation packs droplets past ANY compilable
# capacity (the recorded occupancy curves show stored max CLIPPING probe
# capacities of 15-16 by step ~300 at n=1M and 4.2M, and pair work grows
# as capacity^2). LJ therefore always runs clipped with the
# loss-free deferral absorbing the excess; what capacity buys is keeping
# chronic deferral below the drop threshold, and the required floor grows
# with the number of bins (extreme-value statistics over hot pockets):
# effective 11 passes at <= 1.09M bins (4.2M parts, 48k deferrals) but
# DROPS 5 particles at 5.45M bins (20.97M parts), where effective 13
# passes (deferred 10969, dropped 0). The floor
# below encodes exactly that measured boundary; beyond the measured range
# the engines' drop-detected escalation retry (engines/grid3d.py) is the
# backstop.
_AUTO3_BASE_CAPACITY = 10
_LJ_FLOOR_BINS = 2 ** 21  # between the 1.09M-bin pass and the 5.45M drop
_LJ_FLOOR_CAPACITY = 13  # measured-safe effective capacity at 5.45M bins

# Speed-tail margin for the auto rebin cadence: collisions heat the
# velocity tail over a 1000-step run well past the nominal grid3_vmax
# bound (observed: max speed 5.21 at n=4.2M / density 7e-6 vs the
# assumed 4.0 — the post-run slack check rejected the cadence-3 run).
# The cadence is chosen as if speeds reach TAIL * grid3_vmax; the
# engine's post-run check still verifies against the MEASURED maximum.
_VMAX_TAIL = 1.5


@dataclasses.dataclass(frozen=True)
class Geometry3S:
    ys: int  # y bins (outer blocked axis; the shard-strip axis) — PHYSICAL
    xs: int  # x bins (padded to a multiple of 8)
    zs: int  # z bins (padded to a multiple of 128)
    xs_pad: int
    zs_pad: int
    # Array y extent >= ys (the sharded engine pads to P * ys_local; slabs
    # past ``ys`` are permanent padding, like rows_pad in the 2D geometry).
    # Physical clamps (slab3_dirs, packing) always use ``ys``.
    ys_pad: int
    capacity: int
    # Per-axis bin sides. Anisotropic when lane-snapped (for_config below);
    # bsx * bsy * bsz always equals grid3_bin_size^3, so MEAN occupancy is
    # geometry-independent — but the axis-pass rebin's transient headroom is
    # not: boundary-crossing traffic along an axis scales as 1/bs, so a
    # thin snapped axis needs extra capacity slots (see for_config).
    bsy: float
    bsx: float
    bsz: float

    @classmethod
    def for_config(cls, config, sublane: int = 8, lane: int = 128) -> "Geometry3S":
        """Choose the 3D grid geometry for ``config``.

        At fixed occupancy the PHYSICAL bin count is invariant — what varies
        across geometries is padding: (X, Z) planes pad x to multiples of 8
        and z to multiples of 128, and a cubic grid's z count (64..163 at
        the benchmark sizes) pads up to 2x of every plane the step and
        rebin passes touch. With ``grid3_snap_lanes`` the
        z bin count snaps to a multiple of 128 (exact-cover bins, bsz =
        size/zs), x to a multiple of 8, and y absorbs the occupancy
        compensation. Candidates that leave less than one auto-cadence step
        of stale-bin slack on any axis are rejected; the survivor with the
        lowest padded volume x rebin-cadence cost wins (the isotropic
        geometry is always a candidate, and tiny test grids always fall
        back to it).
        """
        n0 = config.grid3_bins_per_side
        b0 = config.grid3_bin_size
        L = config.size
        cands = [dict(ys=n0, xs=n0, zs=n0, bsy=b0, bsx=b0, bsz=b0)]
        if config.grid3_snap_lanes and n0 > 1:
            min_bs = config.cutoff + 2.0 * config.grid3_vmax * config.dt
            vol = b0 ** 3
            for zs in sorted({lane * (n0 // lane), lane * -(-n0 // lane)}):
                if zs < lane:
                    continue
                bsz = L / zs
                if bsz < min_bs:
                    continue
                bxy = math.sqrt(vol / bsz)
                xs = max(sublane, -(-math.ceil(L / bxy) // sublane) * sublane)
                bsx = L / xs
                if bsx < min_bs:
                    continue
                bsy = vol / (bsx * bsz)
                if bsy < min_bs:
                    continue
                ys = max(1, math.ceil(L / bsy))
                cands.append(dict(ys=ys, xs=xs, zs=zs,
                                  bsy=bsy, bsx=bsx, bsz=bsz))

        base_capacity = config.grid3_capacity
        lj_floor = 0
        if base_capacity is None:
            base_capacity = _AUTO3_BASE_CAPACITY
            # Attractive-tail capacity floor, calibrated (see the
            # _LJ_FLOOR_* notes above). Keyed on the PHYSICAL bin count,
            # which is geometry-invariant at fixed occupancy, so every
            # candidate gets the same floor. Hand-set capacities skip it:
            # ablations need to be able to under-provision on purpose.
            if config.force_law == "lj" and n0 ** 3 >= _LJ_FLOOR_BINS:
                lj_floor = _LJ_FLOOR_CAPACITY

        def geom_of(c):
            # Capacity headroom for anisotropy: the axis-factorized rebin
            # defers a mover when its destination bin is transiently full,
            # and the per-bin arrival traffic along an axis scales as
            # 1/bs_axis. Observed at n=1M (snapped 43x48x128 grid,
            # bsz = b0/2): capacity 10 chronically defers ~75 movers/step
            # and eventually drops far-drifters; capacity 12 cuts deferrals
            # 40x and drops to zero. At n=16.8M even a mild ratio of 1.18
            # dropped 3 particles with zero headroom, so any anisotropy
            # earns at least one slot (ceil). The admission gate above
            # (bs >= cutoff + 2*vmax*dt) bounds the ratio near 2, so the
            # headroom is clamped at 2. The candidate pays for the extra
            # slot planes in cost() below, so thin-axis snaps only win
            # when the lane savings exceed the capacity tax.
            ratio = b0 / min(c["bsx"], c["bsy"], c["bsz"])
            extra = min(2, max(0, math.ceil(2.0 * (ratio - 1.0) - 1e-9)))
            capacity = base_capacity + extra
            if lj_floor:
                capacity = max(capacity, lj_floor)
            return cls(
                ys=c["ys"], xs=c["xs"], zs=c["zs"],
                xs_pad=-(-c["xs"] // sublane) * sublane,
                zs_pad=-(-c["zs"] // lane) * lane,
                ys_pad=c["ys"],
                capacity=capacity,
                bsy=c["bsy"], bsx=c["bsx"], bsz=c["bsz"],
            )

        def cost(g):
            vol_pad = g.capacity * g.ys * g.xs_pad * g.zs_pad
            return vol_pad * (1.0 + _REBIN_COST_FACTOR / g.cadence(config))

        return min((geom_of(c) for c in cands), key=cost)

    def cadence(self, config) -> int:
        """Rebin cadence: the explicit ``rebin3_every`` override, else the
        largest cadence (capped at 8) whose worst-case drift at
        ``_VMAX_TAIL * grid3_vmax`` (speed tails heat past the nominal
        bound over a run) stays inside the tightest axis's stale-bin
        slack. The runtime check (engines/grid3d.py) re-verifies against
        the MEASURED max speed."""
        if config.rebin3_every is not None:
            return config.rebin3_every
        slack = (min(self.bsx, self.bsy, self.bsz) - config.cutoff) / 2.0
        step_drift = _VMAX_TAIL * config.grid3_vmax * config.dt
        return max(1, min(8, int(slack / step_drift)))

    @property
    def shape(self):
        return (self.capacity, self.ys_pad, self.xs_pad, self.zs_pad)


class Slab3State(NamedTuple):
    xl: jax.Array  # (cap, Y, X, Z) bin-local x, BIG where empty
    yl: jax.Array
    zl: jax.Array
    vx: jax.Array
    vy: jax.Array
    vz: jax.Array
    pid: jax.Array  # int32, -1 where empty


# ----------------------------------------------------------------- packing
def _home_bins(pos, geom: Geometry3S):
    """Per-axis home bin indices and the padded-flat bin id for each row."""
    bx = jnp.clip((pos[:, 0] * jnp.float32(1.0 / geom.bsx)).astype(jnp.int32),
                  0, geom.xs - 1)
    by = jnp.clip((pos[:, 1] * jnp.float32(1.0 / geom.bsy)).astype(jnp.int32),
                  0, geom.ys - 1)
    bz = jnp.clip((pos[:, 2] * jnp.float32(1.0 / geom.bsz)).astype(jnp.int32),
                  0, geom.zs - 1)
    return bx, by, bz, (by * geom.xs_pad + bx) * geom.zs_pad + bz


def slab3_from_particles(pos, vel, geom: Geometry3S, rank_mode: str = "sort"):
    """Pack an (N, 3) particle list into the 3D slab grid (init path).

    Same sort+rank+scatter as the 2D packer (grid_ops.slab_from_particles);
    ``rank_mode`` "claim" swaps the argsort for the sort-free scatter-min
    ranking (binning.claim_ranks): identical (bin, slot) assignment,
    locals within 1 ulp (see grid_ops.slab_from_particles).
    Returns (Slab3State, overflow_count).
    """
    pos = jnp.asarray(pos, jnp.float32)
    vel = jnp.asarray(vel, jnp.float32)
    _, _, _, bin_id = _home_bins(pos, geom)
    return _scatter_pack(pos, vel, bin_id, geom, rank_mode)


def _scatter_pack(pos, vel, bin_id, geom: Geometry3S, rank_mode: str = "sort"):
    """Sort+rank+scatter tail shared by the plain and spill packers. The
    slot a particle lands in derives from ``bin_id`` (its RESIDENCE bin),
    so local coordinates are stored relative to that bin's origin — a
    spilled particle's local coordinate sits just outside [0, bs), exactly
    like a rebin-deferred mover's."""
    from ppsim_tpu.ops.binning import chunked_scatter, claim_ranks, sort_by_bin

    plane = geom.ys_pad * geom.xs_pad * geom.zs_pad
    nslots = geom.capacity * plane
    if rank_mode == "claim":
        # Chunked scatters throughout: claim mode is the COMPILE-SAFE pack
        # (see grid_ops.slab_from_particles and binning.SCATTER_CHUNK).
        rank = claim_ranks(bin_id, plane, geom.capacity)
        flat = jnp.where(rank < geom.capacity, rank * plane + bin_id, nslots)
        order = jnp.arange(pos.shape[0], dtype=jnp.int32)
        home_id = bin_id
        counts = chunked_scatter(
            jnp.zeros((plane,), jnp.int32), bin_id,
            jnp.ones((bin_id.shape[0],), jnp.int32), "add")
        max_count = counts.max()
    else:
        order, sorted_id, rank = sort_by_bin(bin_id)
        flat = jnp.where(rank < geom.capacity, rank * plane + sorted_id, nslots)
        home_id = sorted_id
        max_count = rank.max() + 1

    xz = geom.xs_pad * geom.zs_pad
    yy = (home_id // xz).astype(jnp.float32)
    xx = ((home_id % xz) // geom.zs_pad).astype(jnp.float32)
    zz = (home_id % geom.zs_pad).astype(jnp.float32)
    if rank_mode == "claim":
        # order is the identity: index directly (large arange gathers hit
        # the same backend expansion as scatters — see binning.SCATTER_CHUNK).
        px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
        vx_v, vy_v, vz_v = vel[:, 0], vel[:, 1], vel[:, 2]
    else:
        px, py, pz = pos[order, 0], pos[order, 1], pos[order, 2]
        vx_v, vy_v, vz_v = vel[order, 0], vel[order, 1], vel[order, 2]

    def scatter(vals, fill, dtype):
        out = jnp.full((nslots,), fill, dtype)
        if rank_mode == "claim":
            out = chunked_scatter(out, flat, vals.astype(dtype))
        else:
            out = out.at[flat].set(vals.astype(dtype), mode="drop")
        return out.reshape(geom.shape)

    state = Slab3State(
        scatter(px - xx * jnp.float32(geom.bsx), BIG, jnp.float32),
        scatter(py - yy * jnp.float32(geom.bsy), BIG, jnp.float32),
        scatter(pz - zz * jnp.float32(geom.bsz), BIG, jnp.float32),
        scatter(vx_v, 0.0, jnp.float32),
        scatter(vy_v, 0.0, jnp.float32),
        scatter(vz_v, 0.0, jnp.float32),
        scatter(order.astype(jnp.int32), -1, jnp.int32),
    )
    overflow = jnp.maximum(max_count - geom.capacity, 0).astype(jnp.int32)
    return state, overflow


# Claim-mode spill selection: scatter-min rounds per bin (spills/bin are
# bounded by this; measured stretch-scale need is 1 — BASELINE.md).
_CLAIM_SPILL = 4


def slab3_from_particles_spill(pos, vel, geom: Geometry3S, depth: float,
                               rank_mode: str = "sort"):
    """Deferral-style init pack: place overfull-bin overflow in an adjacent
    bin instead of raising the slot capacity (r5).

    The t=0 lattice at the 20.97M stretch scale packs ONE slot past the
    chooser capacity in ~98k bins while the running rebin absorbs a larger
    instantaneous demand (13-15) loss-free via deferral at that same
    capacity (recorded demand and cadence runs) — so the whole-run
    capacity raise, and its ~(12/11)^2 pair-work tax, exists only to survive the initial pack. This packer instead moves
    one boundary-proximate particle per overfull bin into the face-adjacent
    bin it is within ``depth`` of: the resulting state is indistinguishable
    from a mid-run rebin deferral (particle resides one bin off its
    position's bin, within the stale-slack envelope), which the step
    stencil and the monitors already handle. ``depth`` must be chosen so
    excursion + worst-case drift before the first rebin stays inside the
    stale-bin slack (engines/grid3d.py Grid3DEngine._spill_depth uses the
    same _VMAX_TAIL discipline as the cadence chooser).

    Spill targets need a free slot (pre-spill count < capacity); donors and
    receivers are disjoint (donors are overfull). Rarely, several donors
    may pick the same nearly-full receiver — the final overflow count
    catches that, and the caller falls back to the capacity raise, so a
    failed spill is loss-free by construction.

    Returns (Slab3State, overflow_count, spilled_count).
    """
    from ppsim_tpu.ops.binning import (
        chunked_scatter, claim_ranks, sort_by_bin,
    )

    pos = jnp.asarray(pos, jnp.float32)
    vel = jnp.asarray(vel, jnp.float32)
    bx, by, bz, bid = _home_bins(pos, geom)
    cap = geom.capacity
    n = pos.shape[0]
    nbins = geom.ys_pad * geom.xs_pad * geom.zs_pad
    ones = jnp.ones((n,), jnp.int32)
    if rank_mode == "claim":
        from ppsim_tpu.ops.binning import chunked_gather
        counts = chunked_scatter(
            jnp.zeros((nbins,), jnp.int32), bid, ones, "add")
        gath = chunked_gather
    else:
        counts = jnp.zeros((nbins,), jnp.int32).at[bid].add(1)
        gath = lambda t, i: t[i]
    need = gath(counts, bid) - cap  # >0 exactly in overfull bins
    depth_f = jnp.float32(depth)

    # Nearest eligible face per particle: in-grid neighbor with a free
    # slot, face distance <= depth. strides follow the padded-flat id
    # layout bid = (by*xs_pad + bx)*zs_pad + bz.
    best_dist = jnp.full((n,), jnp.float32(BIG))
    best_delta = jnp.zeros((n,), jnp.int32)
    axes = (
        (bx, pos[:, 0], geom.bsx, geom.xs, geom.zs_pad),
        (by, pos[:, 1], geom.bsy, geom.ys, geom.xs_pad * geom.zs_pad),
        (bz, pos[:, 2], geom.bsz, geom.zs, 1),
    )
    for b_ax, p_ax, bs_ax, dim_ax, stride in axes:
        lo = b_ax.astype(jnp.float32) * jnp.float32(bs_ax)
        for sgn, dist in ((-1, p_ax - lo),
                          (1, lo + jnp.float32(bs_ax) - p_ax)):
            nb = b_ax + sgn
            ok = (nb >= 0) & (nb < dim_ax)
            nbid = jnp.clip(bid + sgn * stride, 0, nbins - 1)
            ok &= gath(counts, nbid) < cap
            cand = ok & (dist <= depth_f) & (dist < best_dist)
            best_delta = jnp.where(cand, sgn * stride, best_delta)
            best_dist = jnp.where(cand, dist, best_dist)

    elig = (need > 0) & (best_delta != 0)
    # Need-bounded selection: rank eligibles first within each home bin and
    # spill only the first (count - capacity) of them per bin. Both modes
    # rank eligibles by original index within the bin, so they select the
    # same donors.
    if rank_mode == "claim":
        # Sort-free: scatter-min claim rounds over eligibles only. Rounds
        # bound the spills per bin; a bin needing more than _CLAIM_SPILL
        # spills keeps its residual overflow and the caller falls back to
        # the capacity raise — loss-free, same as any failed spill.
        rank_e = claim_ranks(bid, nbins, _CLAIM_SPILL, active=elig)
        spill = rank_e < jnp.minimum(need, _CLAIM_SPILL)
    else:
        # Key parity encodes eligibility; nbins*2 stays far inside int32.
        key = bid * 2 + (1 - elig.astype(jnp.int32))
        order2, sorted_key, rank2 = sort_by_bin(key)
        sel = (sorted_key % 2 == 0) & (rank2 < need[order2])
        spill = jnp.zeros((n,), bool).at[order2].set(sel)
    new_bid = jnp.where(spill, bid + best_delta, bid)
    state, overflow = _scatter_pack(pos, vel, new_bid, geom, rank_mode)
    return state, overflow, spill.sum().astype(jnp.int32)


def _offsets(geom: Geometry3S, shape, y0=0):
    """Global (x, y, z) bin-origin offsets for every slot-plane element.
    ``y0``: global index of the first y slab (sharded strips)."""
    nd = len(shape)
    y = y0 + jax.lax.broadcasted_iota(jnp.int32, shape, nd - 3)
    x = jax.lax.broadcasted_iota(jnp.int32, shape, nd - 2)
    z = jax.lax.broadcasted_iota(jnp.int32, shape, nd - 1)
    return (
        x.astype(jnp.float32) * jnp.float32(geom.bsx),
        y.astype(jnp.float32) * jnp.float32(geom.bsy),
        z.astype(jnp.float32) * jnp.float32(geom.bsz),
    )


def slab3_to_particles(state: Slab3State, geom: Geometry3S, num_parts: int,
                       chunked: bool = False):
    """Scatter slab state back to id-ordered (N, 3) pos/vel arrays.

    ``chunked``: bound each scatter's update count (compile-safe frame/
    final programs; see grid_ops.slab_to_particles). Bit-identical."""
    xo, yo, zo = _offsets(geom, state.xl.shape)
    alive = state.pid >= 0
    gx = jnp.where(alive, state.xl + xo, BIG)
    gy = jnp.where(alive, state.yl + yo, BIG)
    gz = jnp.where(alive, state.zl + zo, BIG)
    flat_pid = state.pid.reshape(-1)
    idx = jnp.where(flat_pid >= 0, flat_pid, num_parts)

    def put(tgt, col, vals):
        if not chunked:
            return tgt.at[idx, col].set(vals, mode="drop")
        from ppsim_tpu.ops.binning import SCATTER_CHUNK
        for i in range(0, idx.shape[0], SCATTER_CHUNK):
            tgt = tgt.at[idx[i:i + SCATTER_CHUNK], col].set(
                vals[i:i + SCATTER_CHUNK], mode="drop")
        return tgt

    pos = jnp.zeros((num_parts, 3), jnp.float32)
    vel = jnp.zeros((num_parts, 3), jnp.float32)
    for k, g in enumerate((gx, gy, gz)):
        pos = put(pos, k, g.reshape(-1))
    for k, v in enumerate((state.vx, state.vy, state.vz)):
        vel = put(vel, k, v.reshape(-1))
    return pos, vel


# ------------------------------------------------------------------- shift
def _shifted3(f, dy: int, dx: int, dz: int, geom: Geometry3S, fill=BIG):
    """Element (y, x, z) sees f at bin (y+dy, x+dx, z+dz); out-of-grid (or
    into the x/z padding) -> fill."""
    nd = f.ndim
    rolled = jnp.roll(f, (-dy, -dx, -dz), axis=(nd - 3, nd - 2, nd - 1))
    if dy:
        # Mask at the ARRAY edge, like the x/z axes below: the sharded
        # engine feeds ghost-extended arrays (Y_ext = ys_local + 2h) whose
        # physical boundaries are handled by BIG-filled edge ghosts; masking
        # at geom.ys - 1 would land on an interior slab there (one-sided
        # forces + rebin particle loss with P=1, unmasked wraparound P>=2).
        y = jax.lax.broadcasted_iota(jnp.int32, f.shape, nd - 3)
        edge = f.shape[nd - 3] - 1 if dy == 1 else 0
        rolled = jnp.where(y == edge, fill, rolled)
    if dx:
        x = jax.lax.broadcasted_iota(jnp.int32, f.shape, nd - 2)
        edge = min(geom.xs - 1, f.shape[nd - 2] - 1) if dx == 1 else 0
        rolled = jnp.where(x == edge, fill, rolled)
    if dz:
        z = jax.lax.broadcasted_iota(jnp.int32, f.shape, nd - 1)
        edge = min(geom.zs - 1, f.shape[nd - 1] - 1) if dz == 1 else 0
        rolled = jnp.where(z == edge, fill, rolled)
    return rolled


# ------------------------------------------------------------------- force
def grid3_force_xla(xl, yl, zl, geom: Geometry3S, coef_of):
    """XLA 27-plane stencil force; ``coef_of(r2) -> coef`` is the force-law
    seam (physics.coef_from_r2 / lj_coef_from_r2 partials)."""
    cap = geom.capacity
    ax = jnp.zeros_like(xl)
    ay = jnp.zeros_like(yl)
    az = jnp.zeros_like(zl)
    for dy, dx, dz in DIRS3:
        xn_all = _shifted3(xl, dy, dx, dz, geom)
        yn_all = _shifted3(yl, dy, dx, dz, geom)
        zn_all = _shifted3(zl, dy, dx, dz, geom)
        offx = jnp.float32(dx * geom.bsx)
        offy = jnp.float32(dy * geom.bsy)
        offz = jnp.float32(dz * geom.bsz)

        def body(j, acc, xn_all=xn_all, yn_all=yn_all, zn_all=zn_all,
                 offx=offx, offy=offy, offz=offz):
            ax, ay, az = acc
            xn = jax.lax.dynamic_index_in_dim(xn_all, j, 0, keepdims=True) + offx
            yn = jax.lax.dynamic_index_in_dim(yn_all, j, 0, keepdims=True) + offy
            zn = jax.lax.dynamic_index_in_dim(zn_all, j, 0, keepdims=True) + offz
            ddx = xn - xl
            ddy = yn - yl
            ddz = zn - zl
            coef = coef_of(ddx * ddx + ddy * ddy + ddz * ddz)
            return ax + coef * ddx, ay + coef * ddy, az + coef * ddz

        ax, ay, az = jax.lax.fori_loop(0, cap, body, (ax, ay, az))
    return ax, ay, az


# -------------------------------------------------------------------- move
def grid3_move(state: Slab3State, accel, geom: Geometry3S, dt, size, y0=0):
    """Verlet + wall reflection on the 3D slab grid (3-axis analog of
    grid_ops.grid_move; reference integrator: part1/serial.cpp:44-61)."""
    ax, ay, az = accel
    alive = state.pid >= 0
    dtf = jnp.float32(dt)
    L = jnp.float32(size)

    vx = jnp.where(alive, state.vx + ax * dtf, 0.0)
    vy = jnp.where(alive, state.vy + ay * dtf, 0.0)
    vz = jnp.where(alive, state.vz + az * dtf, 0.0)
    xl = state.xl + vx * dtf
    yl = state.yl + vy * dtf
    zl = state.zl + vz * dtf

    xo, yo, zo = _offsets(geom, xl.shape, y0=y0)

    def reflect(local, off, v):
        g = local + off
        out = (g < 0.0) | (g > L)
        m = jnp.mod(g, 2.0 * L)
        folded = L - jnp.abs(m - L)
        local = jnp.where(out, folded - off, local)
        v = jnp.where(out & (m > L), -v, v)
        return local, v

    xl, vx = reflect(xl, xo, vx)
    yl, vy = reflect(yl, yo, vy)
    zl, vz = reflect(zl, zo, vz)

    xl = jnp.where(alive, xl, BIG)
    yl = jnp.where(alive, yl, BIG)
    zl = jnp.where(alive, zl, BIG)
    speed2 = jnp.where(alive, vx * vx + vy * vy + vz * vz, 0.0)
    return (
        Slab3State(xl, yl, zl, vx, vy, vz, state.pid),
        jnp.sqrt(speed2.max()),
    )


# ------------------------------------------------------------------- rebin
def _axis_pass(state: Slab3State, geom: Geometry3S, evac_cap: int, axis: int,
               y0=0):
    """One 1-D rebin pass: move leavers one hop along ``axis`` (0=y, 1=x,
    2=z) under the loss-free acceptance contract. Returns (state, deferred).

    The 27-direction shuffle factorizes into three axis passes (a (+1,+1,-1)
    mover takes one hop per pass); each pass has TWO directions instead of
    26, so the XLA graph (and its temporary pressure — the former OOM
    ceiling) shrinks ~9x. Physics is unaffected: rebinning relocates
    storage, never positions.
    """
    cap = geom.capacity
    bs = jnp.float32((geom.bsy, geom.bsx, geom.bsz)[axis])
    dy, dx, dz, _, alive = slab3_dirs(state, geom, y0=y0)
    adir = (dy, dx, dz)[axis]

    def shift(f, d, fill):
        trip = [0, 0, 0]
        trip[axis] = d
        return _shifted3(f, trip[0], trip[1], trip[2], geom, fill=fill)

    counts_stay = jnp.where(alive, 1.0, 0.0).sum(axis=0)
    F = jnp.float32(cap) - counts_stay

    FILLS = (BIG, BIG, BIG, 0.0, 0.0, 0.0)
    # state field order is (xl, yl, zl, ...); axis order here is (y, x, z)
    FIELD_OF_AXIS = (1, 0, 2)
    fields = list(state[:6])
    fields[FIELD_OF_AXIS[axis]] = (
        (state.yl, state.xl, state.zl)[axis]
        - adir.astype(jnp.float32) * bs
    )

    outs = [[f[s] for s in range(cap)] for f in state]
    is_empty = state.pid < 0
    empty_rank = (
        jnp.cumsum(jnp.where(is_empty, 1.0, 0.0), axis=0)
        - jnp.where(is_empty, 1.0, 0.0)
    )

    deferred = jnp.zeros((), jnp.int32)
    # Direction -1 has global priority over +1 (deterministic, both sides
    # of a boundary agree). off[+1](b) = entrants already queued at b by
    # the -1 stream, i.e. the -1-movers AT bin b+1: shift by -d_prev = +1
    # (a wrong sign here makes the two streams insert into the SAME empty
    # slots and silently overwrite each other — caught by the loss monitor
    # as 1.5M dropped at n=4.2M on the first run).
    counts_m = jnp.where(alive & (adir == -1), 1.0, 0.0).sum(axis=0)
    off_of = {-1: jnp.zeros_like(F), 1: shift(counts_m, 1, 0.0)}
    for d in (-1, 1):
        mask = alive & (adir == d)
        off_at_dest = shift(off_of[d], d, 0.0)
        F_at_dest = shift(F, d, 0.0)
        rank = jnp.zeros(mask.shape[1:], jnp.float32)
        accepted = []
        for j in range(cap):
            mj = mask[j]
            acc_j = mj & (rank < float(evac_cap)) & (off_at_dest + rank < F_at_dest)
            accepted.append((acc_j, rank))
            rank = rank + jnp.where(mj, 1.0, 0.0)
        for j in range(cap):
            acc_j, _ = accepted[j]
            for k in range(6):
                outs[k][j] = jnp.where(acc_j, FILLS[k], outs[k][j])
            outs[6][j] = jnp.where(acc_j, -1, outs[6][j])
            deferred = deferred + ((mask[j] & ~acc_j).astype(jnp.int32).sum())
        for e in range(evac_cap):
            evac = [jnp.full(mask.shape[1:], FILLS[k], jnp.float32)
                    for k in range(6)]
            epid = jnp.full(mask.shape[1:], -1, jnp.int32)
            for j in range(cap):
                acc_j, rank_j = accepted[j]
                sel = acc_j & (rank_j == float(e))
                for k in range(6):
                    evac[k] = jnp.where(sel, fields[k][j], evac[k])
                epid = jnp.where(sel, state.pid[j], epid)
            cpid = shift(epid, -d, -1)
            cflds = [shift(evac[k], -d, FILLS[k]) for k in range(6)]
            valid = cpid >= 0
            idx = off_of[d] + float(e)
            for s in range(cap):
                sel = valid & is_empty[s] & (empty_rank[s] == idx)
                for k in range(6):
                    outs[k][s] = jnp.where(sel, cflds[k], outs[k][s])
                outs[6][s] = jnp.where(sel, cpid, outs[6][s])

    return Slab3State(*(jnp.stack(o) for o in outs)), deferred


def grid3_rebin_axes(state: Slab3State, geom: Geometry3S, evac_cap: int,
                     y0=0):
    """Axis-factorized 3D rebin: x, z, then y passes (y last so the
    sharded engine's cross-shard hop sees settled in-strip placement).
    Loss-free contract and monitors per the acceptance design in
    grid_ops.grid_rebin's docstring. (An unfactorized 27-direction
    shuffle variant was removed; the factorized form is canonical.)

    The passes run through a ``lax.scan`` over a ``lax.switch`` of the
    three per-axis bodies so XLA's peak temporary footprint is ONE pass,
    not the sum of three — at n=20M the state alone is 2.3 GB and the
    difference decides whether the program fits HBM.
    """
    alive0 = (state.pid >= 0).astype(jnp.int32).sum()
    # Far-mover detection must see the PRE-rebin state: each axis pass clamps
    # movement to one hop, so a 2-bin drifter (stale-slack violation, fatal in
    # the 2D contract) would look like a benign 1-bin mover afterwards.
    _, _, _, far0, _ = slab3_dirs(state, geom, y0=y0)

    def one(carry, axis_idx):
        st, dfr = carry
        st2, d2 = jax.lax.switch(
            axis_idx,
            [functools.partial(_axis_pass, geom=geom, evac_cap=evac_cap,
                               axis=a, y0=y0) for a in (0, 1, 2)],
            st,
        )
        return (st2, jnp.maximum(dfr, d2)), None

    (state, _), _ = jax.lax.scan(
        one, (state, jnp.zeros((), jnp.int32)),
        jnp.array([1, 2, 0], jnp.int32),  # x, z, y
    )
    # deferred = residual movers after all passes (post-hoc — the same
    # definition the 2D variants use, so monitor values are comparable
    # across every rebin implementation)
    dy2, dx2, dz2, _, alive2 = slab3_dirs(state, geom, y0=y0)
    deferred = (
        (alive2 & ((dy2 != 0) | (dx2 != 0) | (dz2 != 0))).astype(jnp.int32).sum()
    )
    occupancy_planes = (state.pid >= 0).astype(jnp.int32)
    occupancy = occupancy_planes.sum(axis=0).max()
    lost = alive0 - occupancy_planes.sum()
    dropped = (lost + far0.astype(jnp.int32).sum()).astype(jnp.int32)
    return state, RebinMonitors(
        occupancy.astype(jnp.int32), dropped, deferred
    )


def slab3_dirs(state: Slab3State, geom: Geometry3S, y0=0):
    """Per-slot movement direction per axis, clamped to one hop and to the
    physical grid, plus the far-move flag (3-axis slab_dirs)."""
    alive = state.pid >= 0

    def raw(local, bs):
        d = jnp.floor(local * jnp.float32(1.0 / bs)).astype(jnp.int32)
        return jnp.where(alive, d, 0)

    dx_r = raw(state.xl, geom.bsx)
    dy_r = raw(state.yl, geom.bsy)
    dz_r = raw(state.zl, geom.bsz)
    far = alive & (
        (jnp.abs(dx_r) > 1) | (jnp.abs(dy_r) > 1) | (jnp.abs(dz_r) > 1)
    )
    shape = dx_r.shape
    y = y0 + jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    x = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    z = jax.lax.broadcasted_iota(jnp.int32, shape, 3)
    dy = jnp.clip(jnp.clip(dy_r, -1, 1),
                  -jnp.minimum(y, 1), jnp.minimum(geom.ys - 1 - y, 1))
    dx = jnp.clip(jnp.clip(dx_r, -1, 1),
                  -jnp.minimum(x, 1), jnp.minimum(geom.xs - 1 - x, 1))
    dz = jnp.clip(jnp.clip(dz_r, -1, 1),
                  -jnp.minimum(z, 1), jnp.minimum(geom.zs - 1 - z, 1))
    dx = jnp.where(alive, dx, 0)
    dy = jnp.where(alive, dy, 0)
    dz = jnp.where(alive, dz, 0)
    return dy, dx, dz, far, alive
