"""Sort-based rebinning into a capacity-padded bin grid.

The reference rebins three different ways — pointer-chasing migration between
``unordered_set`` bins (part1/serial.cpp:63-70), clear-and-rebuild ``vector``
bins (part1/vecmp.cpp:88-123), and a CUDA ``atomicAdd`` slot scatter into
fixed-capacity bins (part3/gpu.cu:92-112). XLA needs static shapes, so the
lock-free formulation is:

1. ``bin_id = row * ncols + col`` per particle (row along x, matching the
   reference's ``row = floor(x / BIN_SIZE)``, serial.cpp:43 — and the MPI
   strip axis, part2/mpi.cpp:47-51);
2. stable argsort by ``bin_id`` — particles land contiguous by bin;
3. rank-within-bin via a segmented iota (associative max-scan over segment
   starts), which is the lock-free analog of the CUDA ``atomicAdd`` slot
   reservation;
4. scatter positions into a dense ``(num_bins + 1, capacity)`` grid.

Bin ``num_bins`` is a synthetic *void bin*: every slot keeps the ``BIG``
sentinel position, so out-of-bounds stencil neighbors can be redirected there
and fail the cutoff test with no extra masking. Empty slots likewise hold
``BIG``, which removes any need to gather an occupancy mask in the force pass.

Overflowing a bin's capacity is detected (``BinGrid.max_count``) — the
reference's CUDA engine silently corrupts in that case (gpu.cu:109-111 writes
past slot 16 unchecked).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["BIG", "GridGeometry", "BinGrid", "bin_ids_of", "sort_by_bin", "build_grid"]

# Sentinel coordinate for empty grid slots; guarantees r2 >> cutoff^2.
BIG = 1.0e9


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static bin-grid geometry (hashable; safe as a jit static arg)."""

    nrows: int
    ncols: int
    capacity: int
    bin_size: float

    @property
    def num_bins(self) -> int:
        return self.nrows * self.ncols

    @property
    def num_slots(self) -> int:
        """Slot count including the trailing void bin."""
        return (self.num_bins + 1) * self.capacity

    @classmethod
    def square(cls, config) -> "GridGeometry":
        n = config.bins_per_side
        return cls(nrows=n, ncols=n, capacity=config.bin_capacity, bin_size=config.bin_size)


class BinGrid(NamedTuple):
    """Dense capacity-padded grid of particle positions.

    ``slot_pos``: ((num_bins+1) * capacity, 2) positions, ``BIG`` where empty.
    ``slot_gid``: same layout, int32 index of the particle occupying the slot
    (index into the *sorted* particle order), -1 where empty.
    ``counts``:   (num_bins,) true occupancy per bin (may exceed capacity).
    ``max_count``: scalar int32 — overflow monitor (> capacity means dropped
    particles; the step is then invalid and should be re-run with a larger
    ``bin_capacity``).
    """

    slot_pos: jax.Array
    slot_gid: jax.Array
    counts: jax.Array
    max_count: jax.Array


def bin_ids_of(pos, geom: GridGeometry):
    """Per-particle (row, col, bin_id). Row indexes x (the strip axis)."""
    inv = 1.0 / geom.bin_size
    r = jnp.clip((pos[..., 0] * inv).astype(jnp.int32), 0, geom.nrows - 1)
    c = jnp.clip((pos[..., 1] * inv).astype(jnp.int32), 0, geom.ncols - 1)
    return r, c, r * geom.ncols + c


def _prefix_max(x):
    """Inclusive prefix maximum by log-doubling (non-negative int32 input).

    ``jax.lax.associative_scan`` is avoided deliberately: its recursive
    lowering has stalled an accelerator compiler at multi-million element
    sizes. log2(n) shifted-max passes compile and run fine at any size.
    """
    n = x.shape[0]
    k = 1
    while k < n:
        shifted = jnp.concatenate([jnp.zeros((k,), x.dtype), x[:-k]])
        x = jnp.maximum(x, shifted)
        k *= 2
    return x


def segment_ranks(sorted_ids):
    """Rank of each element within its run of equal ids (ids must be sorted)."""
    n = sorted_ids.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_ids[1:] != sorted_ids[:-1]]
    )
    seg_start = _prefix_max(jnp.where(is_start, idx, 0))
    return idx - seg_start


def sort_by_bin(bin_id):
    """Stable sort permutation by bin id, plus rank-within-bin per sorted slot."""
    order = jnp.argsort(bin_id, stable=True)
    sorted_id = bin_id[order]
    return order, sorted_id, segment_ranks(sorted_id)


# Max updates per scatter op in the chunked paths (the "claim" pack and the
# chunked unpack). A backend may lower a large 1-D scatter through a sorted
# temporary sized by the update count; chunking bounds that temporary at
# ~2^20 updates. set/min/add scatters compose exactly across chunks (unique
# slots for set; min/add are order-insensitive).
SCATTER_CHUNK = 1 << 20


def chunked_scatter(out, idx, vals, op: str = "set", chunk: int = None):
    """``out.at[idx].set/min/add(vals, mode="drop")`` as K bounded scatters
    (see SCATTER_CHUNK). Bit-identical to the single scatter."""
    chunk = SCATTER_CHUNK if chunk is None else chunk
    n = idx.shape[0]
    for i in range(0, n, chunk):
        upd = getattr(out.at[idx[i:i + chunk]], op)
        out = upd(vals[i:i + chunk], mode="drop")
    return out


def chunked_gather(table, idx, chunk: int = None):
    """``table[idx]`` as K bounded gathers (see SCATTER_CHUNK).
    Bit-identical to the single gather."""
    chunk = SCATTER_CHUNK if chunk is None else chunk
    n = idx.shape[0]
    if n <= chunk:
        return table[idx]
    return jnp.concatenate(
        [table[idx[i:i + chunk]] for i in range(0, n, chunk)])


def claim_ranks(bin_id, num_bins: int, rounds: int, active=None):
    """Sort-free within-bin ranks, in ORIGINAL index order.

    ``rounds`` iterations of scatter-min index claiming: round ``k`` gives
    rank ``k`` to the smallest still-unplaced original index in each bin —
    exactly the stable-sort rank assignment (``sort_by_bin``'s ranks for
    ranks < rounds), with no n-element sort and every scatter chunked
    (see SCATTER_CHUNK). O(rounds * n) scatter work vs the sort's
    O(n log n): an alternative pack, not the default.

    ``active``: optional bool mask; inactive particles never claim (used
    by the spill packer's need-bounded eligible ranking). Particles left
    unplaced after ``rounds`` get rank == ``rounds`` (callers treat that
    as overflow/not-selected; pair with a scatter-add occupancy count for
    the overflow monitor).
    """
    n = bin_id.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    rank = jnp.full((n,), rounds, jnp.int32)
    placed = jnp.zeros((n,), bool) if active is None else ~active
    for k in range(rounds):
        cand = jnp.where(placed, n, idx)
        winner = chunked_scatter(
            jnp.full((num_bins,), n, jnp.int32), bin_id, cand, "min")
        won = chunked_gather(winner, bin_id) == idx
        rank = jnp.where(won, k, rank)
        placed = placed | won
    return rank


def build_grid(pos_sorted, sorted_bin_id, rank, geom: GridGeometry) -> BinGrid:
    """Scatter bin-sorted particles into the dense grid.

    ``pos_sorted`` must already be permuted into bin order; ``rank`` is the
    within-bin slot index from :func:`sort_by_bin`. Particles ranked past
    ``capacity`` are dropped from the grid (and flagged via ``max_count``).
    """
    n, dim = pos_sorted.shape
    cap = geom.capacity
    num_slots = geom.num_slots

    # Out-of-capacity ranks map to slot index num_slots -> dropped by XLA.
    slot = jnp.where(rank < cap, sorted_bin_id * cap + rank, num_slots)

    slot_pos = jnp.full((num_slots, dim), BIG, dtype=pos_sorted.dtype)
    slot_pos = slot_pos.at[slot].set(pos_sorted, mode="drop")

    slot_gid = jnp.full((num_slots,), -1, dtype=jnp.int32)
    slot_gid = slot_gid.at[slot].set(jnp.arange(n, dtype=jnp.int32), mode="drop")

    counts = jnp.zeros((geom.num_bins,), jnp.int32).at[sorted_bin_id].add(
        1, mode="drop"
    )
    return BinGrid(slot_pos, slot_gid, counts, counts.max().astype(jnp.int32))
