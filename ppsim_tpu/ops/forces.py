"""3x3 neighbor-bin stencil forces over the capacity-padded grid.

The vectorized analog of the reference's force phase: the serial/OpenMP
``calculate_bin_forces`` 3x3 stencil walk (part1/serial.cpp:102-117,
part1/openmp.cpp:88-117) and the CUDA thread-per-bin ``compute_forces_gpu``
kernel (part3/gpu.cu:115-142). Instead of iterating container contents, each
particle gathers the 9 neighbor bins' capacity-padded slots and accumulates a
masked repulsive force; empty slots hold the ``BIG`` sentinel and fail the
cutoff test for free. The accumulation loops over the 9 offsets so the live
temporary stays at (N, capacity) — not (N, 9*capacity) — keeping HBM traffic
bounded at large N.

One-way force accumulation (no Newton's-third-law halving) matches the
reference's deliberate choice (part1 write-up p.9).
"""

from __future__ import annotations

import jax.numpy as jnp

from ppsim_tpu.ops.binning import GridGeometry
from ppsim_tpu.physics import accel_from_deltas

__all__ = ["stencil_accel"]

STENCIL = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1))


def stencil_accel(
    pos,
    row,
    col,
    slot_pos,
    geom: GridGeometry,
    cutoff: float,
    min_r: float,
    mass: float,
    pair_fn=None,
):
    """Accelerations on query particles from all particles in the 3x3 stencil.

    ``pos``: (N, 2) query positions; ``row``/``col``: (N,) their bin coords in
    the grid described by ``geom`` (for the sharded engine these include the
    ghost-row offset); ``slot_pos``: the grid's ((num_bins+1)*cap, 2) slot
    array. Out-of-grid neighbors are redirected to the void bin. Returns
    (N, 2) accelerations.
    """
    if pair_fn is None:
        pair_fn = lambda dx, dy: accel_from_deltas(dx, dy, cutoff, min_r, mass)
    cap = geom.capacity
    n = pos.shape[0]
    x = pos[:, 0:1]
    y = pos[:, 1:2]
    cap_iota = jnp.arange(cap, dtype=jnp.int32)[None, :]

    ax = jnp.zeros((n,), pos.dtype)
    ay = jnp.zeros((n,), pos.dtype)
    for dr, dc in STENCIL:
        nr = row + dr
        nc = col + dc
        valid = (nr >= 0) & (nr < geom.nrows) & (nc >= 0) & (nc < geom.ncols)
        nb = jnp.where(valid, nr * geom.ncols + nc, geom.num_bins)
        idx = nb[:, None] * cap + cap_iota  # (N, cap)
        npos = slot_pos[idx]  # (N, cap, 2) gather
        dax, day = pair_fn(npos[..., 0] - x, npos[..., 1] - y)
        ax = ax + dax.sum(axis=1)
        ay = ay + day.sum(axis=1)
    return jnp.stack([ax, ay], axis=-1)
