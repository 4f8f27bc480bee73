#!/usr/bin/env python
"""Offline (CPU) probe: 3D headline geometry vs config, t=0 packing, and
spill feasibility at the chooser capacity.

Questions this answers before any engine change (r5):
  1. Why did the cadence A/B (rebin3_every=2 explicit) pack 11 while the
     repack A/B / CLI gate (auto cadence) packed 12 at the same n/seed —
     same geometry or a chooser divergence?
  2. If the geometry is the same: for each overfull bin at the chooser
     capacity, is there a particle within (slack - drift) of a face whose
     neighbor has a free slot — i.e. can a deferral-style init spill place
     the overflow loss-free without raising capacity?
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppsim_tpu.testing import force_cpu_devices

force_cpu_devices(1)

import numpy as np

from ppsim_tpu.config import SimConfig
from ppsim_tpu.initlib import init_particles
from ppsim_tpu.ops.grid3d_ops import Geometry3S

N = 20_971_520

cfg_auto = SimConfig(num_parts=N, ndim=3, density=7e-6, force_law="repulsive")
cfg_cad2 = SimConfig(num_parts=N, ndim=3, density=7e-6, force_law="repulsive",
                     rebin3_every=2)

for tag, cfg in (("auto", cfg_auto), ("cad2", cfg_cad2)):
    g = Geometry3S.for_config(cfg)
    print(f"{tag}: ys={g.ys} xs={g.xs} zs={g.zs} cap={g.capacity} "
          f"bsy={g.bsy:.6f} bsx={g.bsx:.6f} bsz={g.bsz:.6f} "
          f"cadence={g.cadence(cfg)}")

cfg = cfg_auto
g = Geometry3S.for_config(cfg)
state = init_particles(cfg, seed=42, method="fast")
pos = np.asarray(state.pos, np.float32)

bx = np.clip((pos[:, 0] * np.float32(1.0 / g.bsx)).astype(np.int32), 0, g.xs - 1)
by = np.clip((pos[:, 1] * np.float32(1.0 / g.bsy)).astype(np.int32), 0, g.ys - 1)
bz = np.clip((pos[:, 2] * np.float32(1.0 / g.bsz)).astype(np.int32), 0, g.zs - 1)
nb = g.ys * g.xs * g.zs
bid = (by.astype(np.int64) * g.xs + bx) * g.zs + bz
counts = np.bincount(bid, minlength=nb)
print(f"packing: max={counts.max()} bins_at_max={(counts == counts.max()).sum()} "
      f"mean={counts.mean():.3f}")
for c in range(int(counts.max()), int(counts.max()) - 4, -1):
    print(f"  bins with count {c}: {(counts == c).sum()}")

cap = g.capacity
print(f"chooser capacity = {cap}")
over_bins = np.flatnonzero(counts > cap)
print(f"overfull bins at cap {cap}: {len(over_bins)} "
      f"(total overflow particles {int((counts[over_bins] - cap).sum())})")

slack = (min(g.bsx, g.bsy, g.bsz) - cfg.cutoff) / 2.0
# drift at the auto cadence with a generous vmax estimate (measured run
# max_speed ~4.0 at this config; t=0 |v| <= sqrt(3)).
cad = g.cadence(cfg)
drift0 = cad * np.sqrt(3.0) * cfg.dt  # t=0 bound before the first rebin
print(f"slack={slack:.6f} cadence={cad} drift_t0<={drift0:.6f} "
      f"budget(slack-drift)={slack - drift0:.6f}")

# Per overfull bin: find particles in it, their min face distance where the
# neighbor bin is in-grid and has a free slot.
bs = np.array([g.bsx, g.bsy, g.bsz])
dims = np.array([g.xs, g.ys, g.zs])
order = np.argsort(bid, kind="stable")
sorted_bid = bid[order]
starts = np.searchsorted(sorted_bid, over_bins)
ends = np.searchsorted(sorted_bid, over_bins, side="right")

for depth_name, depth in (("slack-drift", slack - drift0),
                          ("0.5*slack", 0.5 * slack),
                          ("slack", slack)):
    ok = 0
    for s, e, b in zip(starts, ends, over_bins):
        idx = order[s:e]
        p = pos[idx]
        cell = np.array([bx[idx][0], by[idx][0], bz[idx][0]])
        need = counts[b] - cap
        placed = 0
        # face distances per particle per axis
        for ax, coord_ax in ((0, 0), (1, 1), (2, 2)):
            lo = cell[ax] * bs[ax]
            hi = (cell[ax] + 1) * bs[ax]
            for side, dist, nbr_cell in ((-1, p[:, coord_ax] - lo, cell[ax] - 1),
                                         (+1, hi - p[:, coord_ax], cell[ax] + 1)):
                if nbr_cell < 0 or nbr_cell >= dims[ax]:
                    continue
                ncell = cell.copy()
                ncell[ax] = nbr_cell
                nbid = (int(ncell[1]) * g.xs + int(ncell[0])) * g.zs + int(ncell[2])
                free = cap - counts[nbid]
                if free <= 0:
                    continue
                n_elig = int((dist <= depth).sum())
                placed += min(n_elig, free)
        if placed >= need:
            ok += 1
    print(f"depth={depth_name} ({depth:.6f}): {ok}/{len(over_bins)} overfull "
          "bins fully spillable")
