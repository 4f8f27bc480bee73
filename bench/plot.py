#!/usr/bin/env python
"""Plots from bench JSONL records (analog of part1/plot.py, which hard-codes
its benchmark arrays; here the data comes from bench/sweep.py output).

Produces:
- linear.png       log-log time vs n per engine, with O(n) guide line
  (cf. part1/plot.py:12-23's linear.png)
- strong-scale.png time vs devices at fixed n (part1/plot.py:26-37)
- weak-scale.png   efficiency vs devices at fixed n/device (part1/plot.py:40-49)
"""

from __future__ import annotations

import argparse
import collections
import json
import sys


def load(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("results", nargs="?", default="bench/results.jsonl")
    ap.add_argument("--outdir", default="bench")
    ap.add_argument("--prefix", default="",
                    help="filename prefix, e.g. '3d-' -> bench/3d-linear.png "
                         "(keeps the 2D and 3D figure sets apart)")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    records = load(args.results)

    # ---- size sweep ------------------------------------------------------
    # Skip A/B ablation rows and dedup re-measured sizes to the best run
    # (the tables report best-of-N; newer rows re-measure the same n).
    best = {}
    for r in records:
        if "ab" in r or "failed" in r or r.get("num_devices", 1) != 1:
            continue
        # A non-default force law is its own series (a file can mix the
        # repulsive sweep with lj rows).
        series = r["engine"]
        law = r.get("force_law", "repulsive")
        if law != "repulsive" and not series.endswith(f"[{law}]"):
            # (one early r2 row already wrote the suffix into "engine")
            series += f"[{law}]"
        key = (series, r["num_parts"])
        if key not in best or r["seconds"] < best[key]["seconds"]:
            best[key] = r
    by_engine = collections.defaultdict(list)
    for (eng, n), r in best.items():
        by_engine[eng].append((n, r["seconds"]))
    if by_engine:
        fig, ax = plt.subplots(figsize=(6, 4.5))
        for eng, pts in sorted(by_engine.items()):
            pts = sorted(pts)
            ax.loglog([p[0] for p in pts], [p[1] for p in pts], "o-", label=eng)
        ns = sorted({p[0] for pts in by_engine.values() for p in pts})
        if ns:
            t0 = min(p[1] for p in next(iter(by_engine.values())))
            ax.loglog(ns, [t0 * n / ns[0] for n in ns], "k--", alpha=0.4, label="O(n)")
        ax.set_xlabel("particles")
        ax.set_ylabel("seconds")
        ax.set_title("time vs problem size")
        ax.legend()
        fig.tight_layout()
        fig.savefig(f"{args.outdir}/{args.prefix}linear.png", dpi=120)

    # ---- device scaling --------------------------------------------------
    # Rows without an "engine" key are per-variant ablation records (the
    # bench/ab_*.py scripts' "variant" rows) — not scaling data.
    sharded = [r for r in records if "engine" in r
               and (r.get("num_devices", 1) > 1
                    or r["engine"].startswith("sharded"))]
    strong = collections.defaultdict(list)
    weak = collections.defaultdict(list)
    for r in sharded:
        strong[r["num_parts"]].append((r["num_devices"], r["seconds"]))
        weak[r["num_parts"] // max(1, r["num_devices"])].append(
            (r["num_devices"], r["seconds"])
        )
    def dedup(pts):
        """One point per device count (best seconds): a file mixing strong
        and weak sweeps can contribute two rows at the same (group, P)."""
        best_p = {}
        for p, s in pts:
            if p not in best_p or s < best_p[p]:
                best_p[p] = s
        return sorted(best_p.items())

    for label, data, fname, ylab in (
        ("strong", strong, "strong-scale.png", "seconds"),
        ("weak", weak, "weak-scale.png", "seconds"),
    ):
        groups = {k: dedup(v) for k, v in data.items() if len(dedup(v)) > 1}
        if not groups:
            continue
        fig, ax = plt.subplots(figsize=(6, 4.5))
        for k, pts in sorted(groups.items()):
            ax.plot([p[0] for p in pts], [p[1] for p in pts], "o-",
                    label=f"n={k}" if label == "strong" else f"n/dev={k}")
        ax.set_xlabel("devices")
        ax.set_ylabel(ylab)
        ax.set_title(f"{label} scaling")
        ax.legend()
        fig.tight_layout()
        fig.savefig(f"{args.outdir}/{args.prefix}{fname}", dpi=120)

    print("plots written to", args.outdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
