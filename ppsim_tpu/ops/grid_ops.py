"""Dense slab-grid representation: the flagship state layout.

The gather-based engine (ops/binning.py + ops/forces.py) mirrors the
reference's structure directly, with per-particle irregular gathers. The slab
grid removes indexed access from the step entirely — the dense answer to the
CUDA engine's bin arrays (part3/gpu.cu:24-27):

- **State lives on the bin grid.** Fields ``xl, yl, vx, vy`` and ``pid`` have
  shape ``(capacity, R, C)``: slot-slab ``j`` is a dense (R, C) plane, so
  every phase is dense elementwise work. ``pid < 0`` marks an empty slot (its
  position parks at the ``BIG`` sentinel, failing every cutoff test).
- **Positions are bin-local** (relative to the bin's origin). Neighbor
  distances are tiny exact differences plus a constant bin offset — no
  catastrophic f32 cancellation even in boxes hundreds of cutoffs wide.
- **Forces** are the 3x3 stencil evaluated as 9 shifted dense planes
  (reference: serial.cpp:102-117 / gpu.cu:115-142), all pairs slab-x-slab.
- **Rebinning is lazy**: a particle may drift out of its bin for up to
  ``rebin_every`` steps; the 3x3 stencil stays correct while total drift is
  below ``(bin_side - cutoff)/2`` (monitored). The rebin itself is a dense
  shuffle — per-direction evacuation compaction + free-slot insertion, all
  rank-match selects, no atomics, no sort (the lock-free answer to
  openmp.cpp:170-177 and gpu.cu:109) — in two selectable factorizations:
  the 9-direction form (``grid_rebin``) and the axis-factorized rows+cols
  form (``grid_rebin_axes``, two directions per pass, the 2D port of the
  3D design).

This module holds the geometry plus the XLA implementations of the three
phases; :mod:`ppsim_tpu.ops.pallas_grid` provides the fused Triton kernel for
the force+move phase (the force is the hot 75%, per the reference's nvprof
split, part3 write-up §6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ppsim_tpu.ops.binning import BIG

__all__ = [
    "SlabGeometry",
    "SlabState",
    "RebinMonitors",
    "slab_from_particles",
    "slab_to_particles",
    "global_positions",
    "grid_force_xla",
    "grid_move",
    "grid_rebin",
    "grid_rebin_axes",
]

# Direction codes: d = (dr+1)*3 + (dc+1); 4 = stay.
DIRS = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)]

# Geometry cost model: ns per particle-step ~ A*planes(cap)/occ*pad
# + B*cap/occ*pad + per-size intercept (the intercept never matters because
# for_config only compares candidates at one problem size). A and B were
# fitted on another machine (``bench/geom_fit.py`` reproduces a fit from
# ``"ab": "grid_geometry"`` rows) and await a refit on the GPU (ROADMAP C4).
# They pick bin size and capacity, so they change the physics schedule and
# are kept until that refit rather than dropped.
_GEOM_COST_A = 0.005479  # pair-plane work
_GEOM_COST_B = 0.173282  # plane traffic + capacity-proportional overheads
# Assumed max |v| for the snap feasibility gate (measured 3.3-4.0 across all
# recorded runs); RunResult.check still gates on the MEASURED speed.
_GEOM_VMAX = 4.0
# Mean-occupancy band the fit covered (scales 3..8 at 4.2M); candidates
# outside it would extrapolate the model, so they are rejected.
_GEOM_OCC_RANGE = (3.0, 13.0)
# Deferral-pressure margin: a candidate must keep mean free slack
# capacity - occ >= headroom + margin. Empirical cliff from the recorded
# geometry runs: picks whose occupancy landed near an integer (free slack
# headroom+0.00 at 16.38M, +0.12 at 20.97M cap 15) suffered persistent
# rebin deferral in hot bins until drift exceeded one bin ("dropped"
# far-movers); every pick with slack >= headroom+0.43 ran drop-free. 0.4
# keeps the 20.97M pick (occ 7.57 -> cap 14) while bumping the two failing
# shapes.
_GEOM_FREE_MARGIN = 0.4
# Candidates whose predicted costs differ by less than the fit's residual
# band are indistinguishable; break such ties toward the LOWEST capacity
# (least rebin deferral pressure, least register pressure in the step
# kernel).
_GEOM_TIE_EPS = 0.01
# Auto slot capacity for the scale-derived (non-snapped) geometry
# (config.grid_capacity notes: cap 10 deferral-cascades at 20M). The snap
# candidates derive theirs from occupancy + headroom instead.
GRID_CAPACITY_DEFAULT = 11


@dataclasses.dataclass(frozen=True)
class SlabGeometry:
    rows: int  # physical bin rows (row indexes x, the strip axis)
    cols: int
    rows_pad: int  # padded for row-blocking
    cols_pad: int  # padded for lane alignment
    capacity: int
    bin_size: float

    @classmethod
    def for_config(cls, config, row_block: int = 8, lane: int = 128) -> "SlabGeometry":
        """Choose the slab geometry for ``config``.

        The default grid is ``ceil(size / grid_bin_size)`` bins per side
        with ``grid_capacity`` slots. With ``grid_snap_lanes`` (and a grid
        wider than 128 bins) snapped candidates are also scored: bin counts
        on multiples of 128 near the default, bin size ``size / m`` (exact
        cover — zero padded rows/cols, where the default pads up to ~12% of
        every plane at sizes like 1M and 4.2M), and capacity following occupancy as ``ceil(occ +
        margin) + headroom`` with headroom = ``grid_capacity -
        ceil(occ_default)`` (both measured capacity sweet spots obey it:
        occ 5.0 -> cap 11, occ 7.2 -> cap 14) and margin the
        deferral-pressure guard ``_GEOM_FREE_MARGIN``. Candidates that
        leave less than one rebin cadence of stale-bin slack at the
        assumed vmax, or whose occupancy leaves the fitted band, are
        rejected; the cost model above picks the winner. The 2D analog of
        ``Geometry3S.for_config``'s snapping (grid3d_ops.py), using scale
        instead of anisotropy because both 2D axes share one bin count.
        """
        bins0 = config.grid_bins_per_side
        bs0 = config.grid_bin_size
        # None = auto (config.grid_capacity docs): the measured scale-5
        # sweet spot. A hand value additionally disables the drop-detected
        # escalation retry (engines/grid.py).
        cap0 = (GRID_CAPACITY_DEFAULT if config.grid_capacity is None
                else config.grid_capacity)

        def geom(m: int, bs: float, cap: int) -> "SlabGeometry":
            return cls(
                rows=m,
                cols=m,
                rows_pad=-(-m // row_block) * row_block,
                cols_pad=-(-m // lane) * lane,
                capacity=cap,
                bin_size=bs,
            )

        default = geom(bins0, bs0, cap0)
        if not (getattr(config, "grid_snap_lanes", False) and bins0 > lane):
            return default

        n = config.num_parts
        headroom = cap0 - math.ceil(n / (bins0 * bins0))
        # Slack feasibility: (bs - cutoff)/2 >= rebin_every * vmax * dt.
        min_bs = config.cutoff + 2.0 * config.rebin_every * _GEOM_VMAX * config.dt

        def cost(g: "SlabGeometry") -> float:
            occ = n / (g.rows * g.cols)
            pad = (g.rows_pad * g.cols_pad) / (g.rows * g.cols)
            planes = g.capacity * (g.capacity - 1) / 2 + 4 * g.capacity**2
            return (_GEOM_COST_A * planes + _GEOM_COST_B * g.capacity) / occ * pad

        cands = [default]
        for k in range(1, -(-bins0 // lane) + 1):
            m = k * lane
            if m == bins0:
                continue  # identical cover to the default
            bs = config.size / (m - 0.5)  # ceil(size / bs) == m, fp-robust
            occ = n / (m * m)
            cap = math.ceil(occ + _GEOM_FREE_MARGIN) + headroom
            if (bs < min_bs or cap < math.ceil(occ) + 2
                    or not _GEOM_OCC_RANGE[0] <= occ <= _GEOM_OCC_RANGE[1]):
                continue
            cands.append(geom(m, bs, cap))
        best = min(cost(g) for g in cands)
        near = [g for g in cands if cost(g) <= best * (1.0 + _GEOM_TIE_EPS)]
        return min(near, key=lambda g: (g.capacity, cost(g)))

    @property
    def shape(self):
        return (self.capacity, self.rows_pad, self.cols_pad)


class SlabState(NamedTuple):
    xl: jax.Array  # (cap, R, C) bin-local x, BIG where empty
    yl: jax.Array
    vx: jax.Array
    vy: jax.Array
    pid: jax.Array  # int32, -1 where empty


class RebinMonitors(NamedTuple):
    max_occupancy: jax.Array  # int32
    dropped: jax.Array  # int32: particles lost (structurally 0; fatal if not)
    deferred: jax.Array  # int32: leavers kept in place this rebin (non-fatal)


# ----------------------------------------------------------------- packing
def slab_from_particles(pos, vel, geom: SlabGeometry, rank_mode: str = "sort"):
    """Device-side packing of a particle list into the slab grid (init path).

    The per-run analog of ``init_simulation``'s initial binning
    (part1/serial.cpp:76-88): sort by bin, rank within bin, scatter into slab
    planes. One-time cost. Returns (SlabState, overflow_count) — overflow
    means the initial occupancy exceeded ``capacity``; engines seed it into
    the carry's monitors (engines/grid.seed_pack_monitors) so the post-run
    check raises without an eager device->host sync in the timed region.

    ``rank_mode``: "sort" (default — argsort by bin) or "claim"
    (binning.claim_ranks — sort-free scatter-min rounds; identical (bin,
    slot) assignment, with bin-local coordinates up to 1 ulp off where
    XLA fuses the `pos - bin*bs` subtract differently).
    """
    from ppsim_tpu.ops.binning import chunked_scatter, claim_ranks, sort_by_bin

    pos = jnp.asarray(pos, jnp.float32)
    vel = jnp.asarray(vel, jnp.float32)
    n = pos.shape[0]
    bs = jnp.float32(geom.bin_size)
    inv = jnp.float32(1.0 / geom.bin_size)
    r = jnp.clip((pos[:, 0] * inv).astype(jnp.int32), 0, geom.rows - 1)
    c = jnp.clip((pos[:, 1] * inv).astype(jnp.int32), 0, geom.cols - 1)
    bin_id = r * geom.cols_pad + c

    plane = geom.rows_pad * geom.cols_pad
    nslots = geom.capacity * plane
    if rank_mode == "claim":
        # Ranks arrive in ORIGINAL index order; scatter source-indexed.
        # Every n-sized scatter here is chunked (binning.SCATTER_CHUNK).
        rank = claim_ranks(bin_id, plane, geom.capacity)
        flat = jnp.where(rank < geom.capacity, rank * plane + bin_id, nslots)
        order = jnp.arange(n, dtype=jnp.int32)
        home_id = bin_id
        counts = chunked_scatter(
            jnp.zeros((plane,), jnp.int32), bin_id,
            jnp.ones((n,), jnp.int32), "add")
        max_count = counts.max()
    else:
        order, sorted_id, rank = sort_by_bin(bin_id)
        flat = jnp.where(rank < geom.capacity, rank * plane + sorted_id, nslots)
        home_id = sorted_id
        max_count = rank.max() + 1

    rr = (home_id // geom.cols_pad).astype(jnp.float32)
    cc = (home_id % geom.cols_pad).astype(jnp.float32)
    if rank_mode == "claim":
        # order is the identity here: index directly (a large arange
        # gather is the same backend-expansion exposure as a scatter).
        xl_v = pos[:, 0] - rr * bs
        yl_v = pos[:, 1] - cc * bs
        vx_v, vy_v, pid_v = vel[:, 0], vel[:, 1], order
    else:
        xl_v = pos[order, 0] - rr * bs
        yl_v = pos[order, 1] - cc * bs
        vx_v, vy_v, pid_v = vel[order, 0], vel[order, 1], order

    def scatter(vals, fill, dtype):
        out = jnp.full((nslots,), fill, dtype)
        if rank_mode == "claim":
            out = chunked_scatter(out, flat, vals.astype(dtype))
        else:
            out = out.at[flat].set(vals.astype(dtype), mode="drop")
        return out.reshape(geom.shape)

    state = SlabState(
        scatter(xl_v, BIG, jnp.float32),
        scatter(yl_v, BIG, jnp.float32),
        scatter(vx_v, 0.0, jnp.float32),
        scatter(vy_v, 0.0, jnp.float32),
        scatter(pid_v.astype(jnp.int32), -1, jnp.int32),
    )
    overflow = jnp.maximum(max_count - geom.capacity, 0).astype(jnp.int32)
    return state, overflow


def global_positions(state: SlabState, geom: SlabGeometry):
    """(cap, R, C, 2) global coordinates (BIG slots stay huge)."""
    bs = jnp.float32(geom.bin_size)
    row_off = jax.lax.broadcasted_iota(jnp.int32, state.xl.shape, 1).astype(jnp.float32) * bs
    col_off = jax.lax.broadcasted_iota(jnp.int32, state.xl.shape, 2).astype(jnp.float32) * bs
    alive = state.pid >= 0
    gx = jnp.where(alive, state.xl + row_off, BIG)
    gy = jnp.where(alive, state.yl + col_off, BIG)
    return gx, gy


def slab_to_particles(state: SlabState, geom: SlabGeometry, num_parts: int,
                      chunked: bool = False):
    """Scatter slab state back to id-ordered (N, 2) pos/vel arrays.

    ``chunked``: bound each scatter's update count (engines pass
    grid_pack_mode == "claim"). Bit-identical output either way."""
    gx, gy = global_positions(state, geom)
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

    pos = jnp.zeros((num_parts, 2), jnp.float32)
    pos = put(pos, 0, gx.reshape(-1))
    pos = put(pos, 1, gy.reshape(-1))
    vel = jnp.zeros((num_parts, 2), jnp.float32)
    vel = put(vel, 0, state.vx.reshape(-1))
    vel = put(vel, 1, state.vy.reshape(-1))
    return pos, vel


# ------------------------------------------------------------------- force
def _shifted(f, dr: int, dc: int, fill=BIG):
    """Plane-shifted view: element (r, c) sees f at (r+dr, c+dc); OOB -> fill."""
    rolled = jnp.roll(f, (-dr, -dc), axis=(-2, -1))
    R, C = f.shape[-2], f.shape[-1]
    if dr:
        row = jax.lax.broadcasted_iota(jnp.int32, f.shape, f.ndim - 2)
        rolled = jnp.where(row == (R - 1 if dr == 1 else 0), fill, rolled)
    if dc:
        col = jax.lax.broadcasted_iota(jnp.int32, f.shape, f.ndim - 1)
        rolled = jnp.where(col == (C - 1 if dc == 1 else 0), fill, rolled)
    return rolled


def pair_coef(dx, dy, cutoff: float, min_r: float, mass: float):
    """Force coefficient for pair offsets; 0 outside cutoff (mirrored
    inside the step kernel, ops/pallas_grid._pair_coef)."""
    r2 = dx * dx + dy * dy
    m = r2 <= cutoff * cutoff
    r2c = jnp.maximum(r2, min_r * min_r)
    rinv = jax.lax.rsqrt(r2c)
    inv2 = rinv * rinv
    return jnp.where(m, (inv2 - cutoff * rinv * inv2) * (1.0 / mass), 0.0)


def grid_force_xla(xl, yl, geom: SlabGeometry, cutoff, min_r, mass, pair_fn=None):
    """XLA implementation of the slab stencil force: the ``grid`` engine's
    force phase and the step kernel's reference (9 x capacity passes over
    the planes)."""
    if pair_fn is None:
        def pair_fn(dx, dy):
            coef = pair_coef(dx, dy, cutoff, min_r, mass)
            return coef * dx, coef * dy
    cap = geom.capacity
    bs = geom.bin_size
    ax = jnp.zeros_like(xl)
    ay = jnp.zeros_like(yl)
    for dr, dc in DIRS:
        xn_all = _shifted(xl, dr, dc)
        yn_all = _shifted(yl, dr, dc)
        offx = jnp.float32(dr * bs)
        offy = jnp.float32(dc * bs)

        def body(j, acc):
            ax, ay = acc
            xn = jax.lax.dynamic_index_in_dim(xn_all, j, 0, keepdims=True)
            yn = jax.lax.dynamic_index_in_dim(yn_all, j, 0, keepdims=True)
            dx = (xn + offx) - xl
            dy = (yn + offy) - yl
            dax, day = pair_fn(dx, dy)
            return ax + dax, ay + day

        ax, ay = jax.lax.fori_loop(0, cap, body, (ax, ay))
    return ax, ay


# -------------------------------------------------------------------- move
def grid_move(state: SlabState, accel, geom: SlabGeometry, dt, size, row0=0,
              col0=0):
    """Verlet + wall reflection on the slab grid (reference: serial.cpp:44-61).

    Empty slots are inert. Reflection reconstructs the global coordinate only
    for out-of-box slots, so in-box particles keep exact bin-local positions.
    ``row0``/``col0`` are the global row/col indexes of the array's first
    row/col (sharded strips pass row0; 2-D tile shards pass both). Returns
    (new_state, max_speed_scalar).
    """
    ax, ay = accel
    alive = state.pid >= 0
    bs = jnp.float32(geom.bin_size)
    dtf = jnp.float32(dt)
    L = jnp.float32(size)

    vx = jnp.where(alive, state.vx + ax * dtf, 0.0)
    vy = jnp.where(alive, state.vy + ay * dtf, 0.0)
    xl = state.xl + vx * dtf
    yl = state.yl + vy * dtf

    row_off = (
        row0 + jax.lax.broadcasted_iota(jnp.int32, xl.shape, 1)
    ).astype(jnp.float32) * bs
    col_off = (
        col0 + jax.lax.broadcasted_iota(jnp.int32, xl.shape, 2)
    ).astype(jnp.float32) * bs

    def reflect(local, off, v):
        g = local + off
        out = (g < 0.0) | (g > L)
        m = jnp.mod(g, 2.0 * L)
        folded = L - jnp.abs(m - L)
        local = jnp.where(out, folded - off, local)
        v = jnp.where(out & (m > L), -v, v)
        return local, v

    xl, vx = reflect(xl, row_off, vx)
    yl, vy = reflect(yl, col_off, vy)

    xl = jnp.where(alive, xl, BIG)
    yl = jnp.where(alive, yl, BIG)
    speed2 = jnp.where(alive, vx * vx + vy * vy, 0.0)
    max_speed = jnp.sqrt(speed2.max())
    return SlabState(xl, yl, vx, vy, state.pid), max_speed


# ------------------------------------------------------------------- rebin
def slab_dirs(state: SlabState, geom: SlabGeometry, row0=0, col0=0):
    """Per-slot movement direction (clamped to one hop and to the physical
    grid) plus the far-move flag. Empty slots get direction 0. ``row0`` /
    ``col0`` are the global row/col indexes of the array's first row/col
    (sharded shards pass their strip/tile offset)."""
    inv_bs = jnp.float32(1.0 / geom.bin_size)
    alive = state.pid >= 0
    dirx_raw = jnp.floor(state.xl * inv_bs).astype(jnp.int32)
    diry_raw = jnp.floor(state.yl * inv_bs).astype(jnp.int32)
    dirx_raw = jnp.where(alive, dirx_raw, 0)
    diry_raw = jnp.where(alive, diry_raw, 0)
    far = alive & ((jnp.abs(dirx_raw) > 1) | (jnp.abs(diry_raw) > 1))
    dirx = jnp.clip(dirx_raw, -1, 1)
    diry = jnp.clip(diry_raw, -1, 1)
    # Never step off the physical grid (x == size exactly would otherwise
    # point at a nonexistent row): clamp at boundary rows/cols — the
    # particle stays binned at the edge, within slack.
    row = row0 + jax.lax.broadcasted_iota(jnp.int32, dirx.shape, 1)
    col = col0 + jax.lax.broadcasted_iota(jnp.int32, diry.shape, 2)
    dirx = jnp.clip(dirx, -jnp.minimum(row, 1), jnp.minimum(geom.rows - 1 - row, 1))
    diry = jnp.clip(diry, -jnp.minimum(col, 1), jnp.minimum(geom.cols - 1 - col, 1))
    # Padded rows/cols beyond the physical grid see inverted clip bounds;
    # they hold no particles, so zero them after the clamp.
    dirx = jnp.where(alive, dirx, 0)
    diry = jnp.where(alive, diry, 0)
    return dirx, diry, far, alive


def rebin_counts(state: SlabState, geom: SlabGeometry, row0=0, col0=0):
    """(9, R, C) float32 count planes: slot [d] = leavers toward DIRS[d];
    slot [4] (the stay direction) = total alive count A."""
    dirx, diry, far, alive = slab_dirs(state, geom, row0=row0, col0=col0)
    planes = []
    for d, (dr, dc) in enumerate(DIRS):
        if (dr, dc) == (0, 0):
            planes.append(jnp.where(alive, 1.0, 0.0).sum(axis=0))
        else:
            mask = alive & (dirx == dr) & (diry == dc)
            planes.append(jnp.where(mask, 1.0, 0.0).sum(axis=0))
    return jnp.stack(planes), far


def grid_rebin(state: SlabState, geom: SlabGeometry, evac_cap: int, row0=0,
               col0=0):
    """Loss-free 9-direction dense shuffle.

    Lock-free analog of the reference's bin migration (serial.cpp:63-70
    pointer moves, gpu.cu:92-112 atomic rebinning), with a key upgrade over
    both: **nothing is ever dropped**. Each (source bin, direction) leaver
    group is admitted to its destination only up to the destination's
    pre-rebin empty-slot budget, under a deterministic global priority
    (DIRS order, then rank within group). Source and destination evaluate
    the *same* acceptance predicate from shared neighborhood count planes,
    so the decision is consistent without any communication — the SPMD
    answer to MPI's sendrecv handshake (part2/mpi.cpp:230-253). Rejected
    leavers simply stay binned where they were (``deferred`` monitor) and
    retry next rebin; reference-style silent overflow corruption
    (gpu.cu:109-111) is structurally impossible.
    """
    cap = geom.capacity
    bs = jnp.float32(geom.bin_size)
    counts, far = rebin_counts(state, geom, row0=row0, col0=col0)
    dirx, diry, _, alive = slab_dirs(state, geom, row0=row0, col0=col0)
    dcode = (dirx + 1) * 3 + (diry + 1)
    F = jnp.float32(cap) - counts[4]  # pre-rebin empty slots per bin

    # off[d](b) = entrants already queued at destination b by groups that
    # precede d in the global priority order.
    off = {}
    acc = jnp.zeros(counts.shape[1:], jnp.float32)
    for d, (dr, dc) in enumerate(DIRS):
        if (dr, dc) == (0, 0):
            continue
        off[d] = acc
        acc = acc + _shifted(counts[d], -dr, -dc, fill=0.0)

    xl_re = state.xl - dirx.astype(jnp.float32) * bs
    yl_re = state.yl - diry.astype(jnp.float32) * bs
    fields = (xl_re, yl_re, state.vx, state.vy)

    xl_out = [state.xl[s] for s in range(cap)]
    yl_out = [state.yl[s] for s in range(cap)]
    vx_out = [state.vx[s] for s in range(cap)]
    vy_out = [state.vy[s] for s in range(cap)]
    pid_out = [state.pid[s] for s in range(cap)]

    is_empty = state.pid < 0  # pre-rebin emptiness: the only slots entrants use
    empty_rank = (
        jnp.cumsum(jnp.where(is_empty, 1.0, 0.0), axis=0)
        - jnp.where(is_empty, 1.0, 0.0)
    )

    deferred = jnp.zeros((), jnp.int32)
    for d, (dr, dc) in enumerate(DIRS):
        if (dr, dc) == (0, 0):
            continue
        mask = alive & (dcode == d)
        # source-side: acceptance against the destination's budget
        off_at_dest = _shifted(off[d], dr, dc, fill=0.0)
        F_at_dest = _shifted(F, dr, dc, fill=0.0)
        rank = jnp.zeros(mask.shape[1:], jnp.float32)
        cands = []  # per e: (xl, yl, vx, vy, pid) compacted accepted leavers
        for e in range(evac_cap):
            cands.append(None)
        accepted_planes = []
        for j in range(cap):
            mj = mask[j]
            acc_j = mj & (rank < float(evac_cap)) & (off_at_dest + rank < F_at_dest)
            accepted_planes.append((acc_j, rank))
            rank = rank + jnp.where(mj, 1.0, 0.0)
        # clear accepted leavers; count deferred
        for j in range(cap):
            acc_j, _ = accepted_planes[j]
            xl_out[j] = jnp.where(acc_j, BIG, xl_out[j])
            yl_out[j] = jnp.where(acc_j, BIG, yl_out[j])
            vx_out[j] = jnp.where(acc_j, 0.0, vx_out[j])
            vy_out[j] = jnp.where(acc_j, 0.0, vy_out[j])
            pid_out[j] = jnp.where(acc_j, -1, pid_out[j])
            deferred = deferred + (
                (mask[j] & ~acc_j).astype(jnp.int32).sum()
            )
        # compact accepted by rank into evac candidate planes
        for e in range(evac_cap):
            exl = jnp.full(mask.shape[1:], BIG, jnp.float32)
            eyl = jnp.full(mask.shape[1:], BIG, jnp.float32)
            evx = jnp.zeros(mask.shape[1:], jnp.float32)
            evy = jnp.zeros(mask.shape[1:], jnp.float32)
            epid = jnp.full(mask.shape[1:], -1, jnp.int32)
            for j in range(cap):
                acc_j, rank_j = accepted_planes[j]
                sel = acc_j & (rank_j == float(e))
                exl = jnp.where(sel, fields[0][j], exl)
                eyl = jnp.where(sel, fields[1][j], eyl)
                evx = jnp.where(sel, fields[2][j], evx)
                evy = jnp.where(sel, fields[3][j], evy)
                epid = jnp.where(sel, state.pid[j], epid)
            cands[e] = (exl, eyl, evx, evy, epid)

        # destination-side: insert group d (sources at -d) at index off+e
        for e in range(evac_cap):
            exl, eyl, evx, evy, epid = cands[e]
            cpid = _shifted(epid, -dr, -dc, fill=-1)
            cxl = _shifted(exl, -dr, -dc)
            cyl = _shifted(eyl, -dr, -dc)
            cvx = _shifted(evx, -dr, -dc, fill=0.0)
            cvy = _shifted(evy, -dr, -dc, fill=0.0)
            valid = cpid >= 0
            idx = off[d] + float(e)
            for s in range(cap):
                sel = valid & is_empty[s] & (empty_rank[s] == idx)
                xl_out[s] = jnp.where(sel, cxl, xl_out[s])
                yl_out[s] = jnp.where(sel, cyl, yl_out[s])
                vx_out[s] = jnp.where(sel, cvx, vx_out[s])
                vy_out[s] = jnp.where(sel, cvy, vy_out[s])
                pid_out[s] = jnp.where(sel, cpid, pid_out[s])

    new_state = SlabState(
        jnp.stack(xl_out), jnp.stack(yl_out), jnp.stack(vx_out),
        jnp.stack(vy_out), jnp.stack(pid_out),
    )
    occupancy_planes = (new_state.pid >= 0).astype(jnp.int32)
    occupancy = occupancy_planes.sum(axis=0).max()
    lost = alive.astype(jnp.int32).sum() - occupancy_planes.sum()
    dropped = (lost + far.astype(jnp.int32).sum()).astype(jnp.int32)
    return new_state, RebinMonitors(
        occupancy.astype(jnp.int32), dropped, deferred
    )


# -------------------------------------------------- axis-factorized rebin
def _axis_pass2(state: SlabState, geom: SlabGeometry, evac_cap: int,
                axis: int, row0=0, col0=0):
    """One 1-D rebin pass: move leavers one hop along ``axis`` (0 = rows/x,
    1 = cols/y) under the loss-free acceptance contract. Returns
    (state, deferred).

    2D port of the 3D design (grid3d_ops._axis_pass): the 9-direction
    shuffle factorizes into two axis passes (a (+1, -1) mover takes one hop
    per pass); each pass has TWO directions instead of 8, so the XLA graph
    shrinks ~3x. Physics is
    unaffected: rebinning relocates storage, never positions. Deferral
    decisions differ from grid_rebin's 9-direction priority order, so
    engine trajectories using the two variants agree to f32 summation
    order (allclose), not bitwise.
    """
    cap = geom.capacity
    bs = jnp.float32(geom.bin_size)
    dirx, diry, _, alive = slab_dirs(state, geom, row0=row0, col0=col0)
    adir = (dirx, diry)[axis]

    def shift(f, d, fill):
        return _shifted(f, d if axis == 0 else 0, d if axis == 1 else 0,
                        fill=fill)

    counts_stay = jnp.where(alive, 1.0, 0.0).sum(axis=0)
    F = jnp.float32(cap) - counts_stay

    FILLS = (BIG, BIG, 0.0, 0.0)
    fields = [state.xl, state.yl, state.vx, state.vy]
    # recenter the moving coordinate into the destination bin's local frame
    fields[axis] = fields[axis] - adir.astype(jnp.float32) * bs

    outs = [[f[s] for s in range(cap)]
            for f in (state.xl, state.yl, state.vx, state.vy, state.pid)]
    is_empty = state.pid < 0
    empty_rank = (
        jnp.cumsum(jnp.where(is_empty, 1.0, 0.0), axis=0)
        - jnp.where(is_empty, 1.0, 0.0)
    )

    deferred = jnp.zeros((), jnp.int32)
    # Direction -1 has global priority over +1 (deterministic, both sides
    # of a boundary agree). off[+1](b) = entrants already queued at b by
    # the -1 stream, i.e. the -1-movers AT bin b+1: shift by +1 (see
    # grid3d_ops._axis_pass for the sign trap this wording pins down).
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
            for k in range(4):
                outs[k][j] = jnp.where(acc_j, FILLS[k], outs[k][j])
            outs[4][j] = jnp.where(acc_j, -1, outs[4][j])
            deferred = deferred + ((mask[j] & ~acc_j).astype(jnp.int32).sum())
        for e in range(evac_cap):
            evac = [jnp.full(mask.shape[1:], FILLS[k], jnp.float32)
                    for k in range(4)]
            epid = jnp.full(mask.shape[1:], -1, jnp.int32)
            for j in range(cap):
                acc_j, rank_j = accepted[j]
                sel = acc_j & (rank_j == float(e))
                for k in range(4):
                    evac[k] = jnp.where(sel, fields[k][j], evac[k])
                epid = jnp.where(sel, state.pid[j], epid)
            cpid = shift(epid, -d, -1)
            cflds = [shift(evac[k], -d, FILLS[k]) for k in range(4)]
            valid = cpid >= 0
            idx = off_of[d] + float(e)
            for s in range(cap):
                sel = valid & is_empty[s] & (empty_rank[s] == idx)
                for k in range(4):
                    outs[k][s] = jnp.where(sel, cflds[k], outs[k][s])
                outs[4][s] = jnp.where(sel, cpid, outs[4][s])

    return SlabState(*(jnp.stack(o) for o in outs)), deferred


def grid_rebin_axes(state: SlabState, geom: SlabGeometry, evac_cap: int,
                    row0=0, col0=0):
    """Axis-factorized 2D rebin: rows (x) pass, then cols (y) pass.

    Same loss-free acceptance contract and monitors as :func:`grid_rebin`
    (see its docstring); the factorization is the 2D port of
    grid3d_ops.grid3_rebin_axes, which replaced the unfactorized
    27-direction 3D shuffle after a recorded 2.3x ablation win. The x
    (row/strip) pass runs FIRST: its acceptance reads only pre-rebin state,
    so the sharded engines' cross-strip hop needs only pre-exchanged ghost
    rows; the y pass is then lane-local within each strip.
    """
    alive0 = (state.pid >= 0).astype(jnp.int32).sum()
    # Far movers must be detected pre-rebin: each axis pass clamps to one
    # hop, so a 2-bin drifter (a fatal stale-slack violation) would look
    # like a benign 1-bin mover afterwards.
    _, _, far0, _ = slab_dirs(state, geom, row0=row0, col0=col0)

    st, _ = _axis_pass2(state, geom, evac_cap, 0, row0=row0, col0=col0)
    st, _ = _axis_pass2(st, geom, evac_cap, 1, row0=row0, col0=col0)
    # deferred = residual movers after both passes (post-hoc, the same
    # definition every rebin variant uses — unlike the in-pass
    # rejection counts, this is well-defined across factorizations)
    dx2, dy2, _, alive2 = slab_dirs(st, geom, row0=row0, col0=col0)
    deferred = (alive2 & ((dx2 != 0) | (dy2 != 0))).astype(jnp.int32).sum()

    occupancy_planes = (st.pid >= 0).astype(jnp.int32)
    occupancy = occupancy_planes.sum(axis=0).max()
    lost = alive0 - occupancy_planes.sum()
    dropped = (lost + far0.astype(jnp.int32).sum()).astype(jnp.int32)
    return st, RebinMonitors(
        occupancy.astype(jnp.int32), dropped, deferred
    )
