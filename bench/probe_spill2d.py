#!/usr/bin/env python
"""Offline (CPU) probe: 2D t=0 packing at the headline scale (r5).

The 2D 20.97M headline runs at the chooser capacity 14 and its run
max_bin_count is exactly 14 — is that the t=0 packing (like 3D, where
the lattice set the binding constraint) or a mid-run demand? And at
capacity 13, how many bins overflow at t=0 and are they spillable
(a boundary-proximate particle with a free-slot neighbor)?
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppsim_tpu.testing import force_cpu_devices

force_cpu_devices(1)

import numpy as np

from ppsim_tpu.config import SimConfig
from ppsim_tpu.initlib import init_particles
from ppsim_tpu.ops.grid_ops import SlabGeometry

N = 20_971_520
cfg = SimConfig(num_parts=N)
g = SlabGeometry.for_config(cfg)
print(f"geom: rows={g.rows} cols={g.cols} cap={g.capacity} "
      f"bin={g.bin_size:.6f}")

state = init_particles(cfg, seed=42)  # auto -> native reference init
pos = np.asarray(state.pos, np.float32)

br = np.clip((pos[:, 1] / np.float32(g.bin_size)).astype(np.int32),
             0, g.rows - 1)
bc = np.clip((pos[:, 0] / np.float32(g.bin_size)).astype(np.int32),
             0, g.cols - 1)
bid = br.astype(np.int64) * g.cols + bc
counts = np.bincount(bid, minlength=g.rows * g.cols)
mx = counts.max()
print(f"t=0 packing max={mx} mean={counts.mean():.3f}")
for c in range(mx, max(mx - 6, 0), -1):
    print(f"  bins with count {c}: {(counts == c).sum()}")

slack = (g.bin_size - cfg.cutoff) / 2.0
print(f"slack={slack:.6f}")

for cap in (13, 12):
    over_bins = np.flatnonzero(counts > cap)
    total_over = int((counts[over_bins] - cap).sum())
    print(f"cap {cap}: {len(over_bins)} overfull bins, "
          f"{total_over} overflow particles")
    if not len(over_bins):
        continue
    order = np.argsort(bid, kind="stable")
    sb = bid[order]
    starts = np.searchsorted(sb, over_bins)
    ends = np.searchsorted(sb, over_bins, side="right")
    for frac, name in ((0.25, "slack/4"), (0.5, "slack/2"), (0.75, "3slack/4")):
        depth = slack * frac
        ok = 0
        for s, e, b in zip(starts, ends, over_bins):
            idx = order[s:e]
            p = pos[idx]
            r, c = int(br[idx][0]), int(bc[idx][0])
            need = counts[b] - cap
            placed = 0
            for (dr, dc, dist) in (
                (0, -1, p[:, 0] - c * g.bin_size),
                (0, +1, (c + 1) * g.bin_size - p[:, 0]),
                (-1, 0, p[:, 1] - r * g.bin_size),
                (+1, 0, (r + 1) * g.bin_size - p[:, 1]),
            ):
                nr, nc = r + dr, c + dc
                if not (0 <= nr < g.rows and 0 <= nc < g.cols):
                    continue
                nb = nr * g.cols + nc
                free = cap - counts[nb]
                if free <= 0:
                    continue
                placed += min(int((dist <= depth).sum()), free)
            if placed >= need:
                ok += 1
        print(f"  depth {name} ({depth:.5f}): {ok}/{len(over_bins)} "
              "overfull bins fully spillable")
