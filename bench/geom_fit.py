#!/usr/bin/env python
"""Refit the 2D grid-geometry cost model from recorded ablation rows.

The model prices a candidate slab geometry (bin count m per side, capacity
cap) in ns per particle-step:

    cost = A * planes(cap)/occ * pad  +  B * cap/occ * pad  +  D_capture

where planes(cap) = cap(cap-1)/2 + 4 cap^2 is the pair-plane count per bin
of a Newton's-third-law step, occ = mean bin occupancy n/m^2, and pad =
padded/physical plane-area ratio (rows pad to 8, cols to 128). The A term
is pair work; the B term absorbs plane traffic plus capacity-proportional
overheads (including the amortized rebin at the default cadence); D is a
per-problem-size intercept that soaks up dispatch floors —
SlabGeometry.for_config only compares candidates at the SAME size, so D
never affects the choice. Fit source: the ``"ab": "grid_geometry"`` rows
that bench/ab_grid.py appends.

The fitted A and B are frozen into ops/grid_ops.py (_GEOM_COST_A/B) where
SlabGeometry.for_config uses them to choose snapped geometries. The
constants there were fitted on another machine; rerun ab_grid.py on the GPU
and this script to refit them (the GPU kernel evaluates 9 cap^2 pair planes
per bin, so planes(cap) changes too).

Usage: python bench/geom_fit.py [--jsonl bench/results.jsonl]
"""

import argparse
import json
import math

import numpy as np


def features(n: int, scale: float, cap: int,
             density: float = 5e-4, cutoff: float = 0.01):
    size = math.sqrt(density * n)
    bins = math.ceil(size / (scale * cutoff))
    rows_pad = -(-bins // 8) * 8
    cols_pad = -(-bins // 128) * 128
    occ = n / (bins * bins)
    pad = (rows_pad * cols_pad) / (bins * bins)
    planes = cap * (cap - 1) / 2 + 4 * cap * cap
    return planes / occ * pad, cap / occ * pad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsonl", default="bench/results.jsonl")
    args = ap.parse_args(argv)

    rows = []
    for line in open(args.jsonl):
        r = json.loads(line)
        if r.get("ab") == "grid_geometry" and "seconds" in r:
            rows.append(r)
    if len(rows) < 4:
        raise SystemExit(f"only {len(rows)} usable ablation rows in {args.jsonl}")

    sizes = sorted({r["num_parts"] for r in rows})
    X, y = [], []
    for r in rows:
        lane, io = features(r["num_parts"], r["grid_bin_scale"],
                            r["grid_capacity"])
        X.append([lane, io] + [1.0 if r["num_parts"] == s else 0.0
                               for s in sizes])
        y.append(r["seconds"] / (r["num_parts"] * r["nsteps"]) * 1e9)
    X = np.array(X)
    y = np.array(y)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    pred = X @ coef
    print(f"A={coef[0]:.6f} B={coef[1]:.6f}  "
          f"intercepts={{{', '.join(f'{s}: {d:.3f}' for s, d in zip(sizes, coef[2:]))}}}"
          f"  ({len(rows)} rows)")
    worst = 0.0
    for r, p, a in zip(rows, pred, y):
        err = abs(p - a) / a
        worst = max(worst, err)
        print(f"  n={r['num_parts']:>9} scale={r['grid_bin_scale']:<7} "
              f"cap={r['grid_capacity']:>2} cad={r['rebin_every']:>2}: "
              f"meas {a:.3f} pred {p:.3f} ns/pstep ({(p - a) / a * 100:+.1f}%)")
    print(f"worst residual {worst * 100:.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
