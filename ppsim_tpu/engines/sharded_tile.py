"""Multi-chip slab-grid engine over a 2-D tile mesh (rows x cols).

The 1-D strip decomposition (engines/sharded_grid.py, the analog of the
reference's MPI row strips, part2/mpi.cpp:258-294) communicates one ghost
ROW per neighbor per step: halo traffic per device is O(cols) while compute
is O(rows_local * cols), so its comm:compute ratio grows linearly with the
device count. A 2-D tile mesh cuts the domain along BOTH bin axes —
surface-to-volume scaling, the standard upgrade the reference's write-up
defers ("2-D decomposition left as future work", part2 PDF) and SURVEY.md §5
marks as the natural extension for pod-scale topologies.

Design notes:

- mesh axes ``("x", "y")`` (x indexes bin rows, y bin cols, matching the
  coordinate convention of ops/grid_ops.py). ``col_block`` rounds col
  tiles up to a multiple (tests keep it small so tiny grids still split).
- **halo with corners**: ghost exchange runs rows first, then cols ON THE
  ROW-EXTENDED arrays, so corner bins arrive via the col neighbor (whose
  row extension already contains the diagonal neighbor's boundary rows) —
  two ppermute rounds, no separate diagonal sends. The reference's MPI
  engine never solves this (1-D strips have no corners).
- **per-tile step**: the grid twin ops on a literal 2-D ghost-ring
  extension — 1 ring for the force stencil, 2 for the rebin.
- **migration**: the loss-free rebin runs on the ghost-ring extension in
  both axes; both sides of every boundary (and all four tiles at a corner)
  evaluate identical acceptance predicates on identical overlapped data, so
  cross-tile transfers are consistent with no handshake — the same
  SPMD-consistency argument as the 1-D engine, applied per axis.

Tested on forced CPU meshes (2x2, 1x4, 4x2) against the single-device grid
engine; ``bench/sweep.py --strong/--weak --engine sharded_tile`` drives it
for scaling measurements.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ppsim_tpu.config import SimConfig
from ppsim_tpu.engines.base import register_engine
from ppsim_tpu.engines.sharded_grid import ShardedGridEngine
from ppsim_tpu.ops import grid_ops
from ppsim_tpu.ops.binning import BIG
from ppsim_tpu.ops.grid_ops import SlabState

__all__ = ["ShardedTileEngine"]


def _mesh_factor(n: int) -> Tuple[int, int]:
    """Near-square (rows, cols) factorization, rows-heavy (a row split keeps
    each tile's rows whole and contiguous in memory)."""
    pc = int(math.sqrt(n))
    while n % pc:
        pc -= 1
    return (n // pc, pc)


@register_engine
class ShardedTileEngine(ShardedGridEngine):
    name = "sharded_tile"

    def __init__(
        self,
        config: SimConfig,
        devices: Optional[Sequence[jax.Device]] = None,
        mesh_shape: Optional[Tuple[int, int]] = None,
        col_block: int = 1,
    ):
        """``mesh_shape``: (row tiles, col tiles); default factors the device
        count near-square. ``col_block``: col tiles are rounded up to a
        multiple of it."""
        # Skip ShardedGridEngine.__init__ (1-D mesh plumbing); take the
        # GridEngine base directly.
        super(ShardedGridEngine, self).__init__(config)
        devices = list(devices) if devices is not None else jax.devices()
        if mesh_shape is None:
            mesh_shape = _mesh_factor(len(devices))
        self.Pr, self.Pc = mesh_shape
        if self.Pr * self.Pc != len(devices):
            raise ValueError(
                f"mesh_shape {mesh_shape} != {len(devices)} devices")
        self.mesh = Mesh(
            np.array(devices).reshape(self.Pr, self.Pc), axis_names=("x", "y")
        )

        base = self.geom
        # Tiles are at least as wide as the rebin's 2-bin ghost ring.
        rows_local = max(2, -(-base.rows // self.Pr))
        cols_local = max(2, -(-base.cols // (self.Pc * col_block)) * col_block)
        self.rows_local, self.cols_local = rows_local, cols_local
        self.geom = dataclasses.replace(
            base, rows_pad=self.Pr * rows_local, cols_pad=self.Pc * cols_local
        )

        spec_f = self._slab_spec
        # check_vma=False: as in the 1-D strip engines.
        self._plain_step = jax.shard_map(
            self._local_plain,
            mesh=self.mesh,
            in_specs=(spec_f,) * 5,
            out_specs=((spec_f,) * 4) + (P(),),
            check_vma=False,
        )
        self._rebin_step = jax.shard_map(
            self._local_move_rebin,
            mesh=self.mesh,
            in_specs=(spec_f,) * 5,
            out_specs=((spec_f,) * 5) + (P(),) * 4,
            check_vma=False,
        )

    _slab_spec = P(None, "x", "y")

    # ------------------------------------------------------------- plumbing
    def _recv(self, x, fill, axis_name: str, np_: int, from_prev: bool):
        """Receive ``x`` from the previous (from_prev) or next device along
        ``axis_name``; the edge device gets ``fill``."""
        filled = jnp.full_like(x, fill)
        if np_ == 1:
            return filled
        if from_prev:
            perm = [(i, i + 1) for i in range(np_ - 1)]
            edge = 0
        else:
            perm = [(i + 1, i) for i in range(np_ - 1)]
            edge = np_ - 1
        out = jax.lax.ppermute(x, axis_name, perm)
        return jnp.where(jax.lax.axis_index(axis_name) == edge, filled, out)

    def _extend2(self, f, fill, h: int):
        """Ghost-extend ``h`` bins on all four sides, corners included:
        rows first, then cols of the row-extended array (the lateral
        neighbor's row extension carries the diagonal neighbor's rows).
        The literal ghost ring of the per-tile step."""
        top = self._recv(f[:, -h:, :], fill, "x", self.Pr, True)
        bot = self._recv(f[:, :h, :], fill, "x", self.Pr, False)
        fe = jnp.concatenate([top, f, bot], axis=1)
        left = self._recv(fe[:, :, -h:], fill, "y", self.Pc, True)
        right = self._recv(fe[:, :, :h], fill, "y", self.Pc, False)
        return jnp.concatenate([left, fe, right], axis=2)

    def _offsets(self):
        row0 = jax.lax.axis_index("x") * self.rows_local
        col0 = jax.lax.axis_index("y") * self.cols_local
        return row0, col0

    def _local_plain(self, xl, yl, vx, vy, pid):
        if self._phase_disable == "move":  # phase_times seam (sharded_grid)
            return xl, yl, vx, vy, jnp.zeros((), jnp.float32)
        return self._local_plain_xla(xl, yl, vx, vy, pid)

    def _local_plain_xla(self, xl, yl, vx, vy, pid):
        from ppsim_tpu.physics import accel_fn_for

        cfg = self.config
        row0, col0 = self._offsets()
        xe = self._extend2(xl, BIG, 1)
        ye = self._extend2(yl, BIG, 1)
        ax, ay = grid_ops.grid_force_xla(
            xe, ye, self.geom, cfg.cutoff, cfg.min_r, cfg.mass,
            pair_fn=accel_fn_for(cfg),
        )
        slab = SlabState(xl, yl, vx, vy, pid)
        new, max_speed = grid_ops.grid_move(
            slab, (ax[:, 1:-1, 1:-1], ay[:, 1:-1, 1:-1]), self.geom,
            cfg.dt, cfg.size, row0=row0, col0=col0,
        )
        max_speed = jax.lax.pmax(max_speed, ("x", "y"))
        return new.xl, new.yl, new.vx, new.vy, max_speed

    def _local_move_rebin(self, xl, yl, vx, vy, pid):
        cfg = self.config
        nxl, nyl, nvx, nvy, max_speed = self._local_plain(xl, yl, vx, vy, pid)
        state = SlabState(nxl, nyl, nvx, nvy, pid)
        row0, col0 = self._offsets()

        if self._phase_disable == "rebin":  # phase_times seam (sharded_grid)
            z = jnp.zeros((), jnp.int32)
            return (state.xl, state.yl, state.vx, state.vy, state.pid,
                    z, z, z, max_speed)

        ext = SlabState(*(
            self._extend2(f, fill, 2)
            for f, fill in ((state.xl, BIG), (state.yl, BIG),
                            (state.vx, 0.0), (state.vy, 0.0),
                            (state.pid, -1))
        ))
        rebin = (grid_ops.grid_rebin_axes
                 if cfg.grid_rebin_mode == "axes" else grid_ops.grid_rebin)
        new_ext, _ = rebin(ext, self.geom, cfg.evac_capacity,
                           row0=row0 - 2, col0=col0 - 2)
        new = SlabState(*(f[:, 2:-2, 2:-2] for f in new_ext))

        axes = ("x", "y")
        before = jax.lax.psum(
            (state.pid >= 0).astype(jnp.int32).sum(), axes)
        occ_planes = (new.pid >= 0).astype(jnp.int32)
        after = jax.lax.psum(occ_planes.sum(), axes)
        # far (fatal slack violation) from the PRE-rebin state — the shuffle
        # clamps a 2-bin drifter to one hop, hiding it post-rebin.
        _, _, far0, _ = grid_ops.slab_dirs(state, self.geom,
                                           row0=row0, col0=col0)
        dirx, diry, _, alive2 = grid_ops.slab_dirs(new, self.geom,
                                                   row0=row0, col0=col0)
        deferred = jax.lax.psum(
            (alive2 & ((dirx != 0) | (diry != 0))).astype(jnp.int32).sum(),
            axes,
        )
        far_n = jax.lax.psum(far0.astype(jnp.int32).sum(), axes)
        occupancy = jax.lax.pmax(occ_planes.sum(axis=0).max(), axes)
        dropped = (before - after) + far_n
        return (new.xl, new.yl, new.vx, new.vy, new.pid,
                occupancy.astype(jnp.int32), dropped.astype(jnp.int32),
                deferred.astype(jnp.int32), max_speed)

    # -------------------------------------------------------- engine hooks
    # move_phase / step_with_rebin / step_carry / rebin_of / init_carry
    # inherit from ShardedGridEngine (same _plain_step/_rebin_step
    # signatures; the pack writes straight into ``_slab_spec``).
