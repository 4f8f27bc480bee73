"""Simulation configuration.

The reference hard-codes the physics constants as compile-time macros shared
by every backend (part1/common.h:4-11, part2/common.h:7-14, part3/common.h:4-11):

    nsteps=1000  savefreq=10  density=0.0005  mass=0.01
    cutoff=0.01  min_r=cutoff/100  dt=0.0005

and scatters engine tunables across the engine sources (``BIN_SIZE``
part1/serial.cpp:11 [0.01] vs part1/vecmp.cpp:10 [0.05]; ``MAX_PTS_PER_BIN``
part3/gpu.cu:10 [16]; ``MAX_NUM_PTS_PER_BIN`` part2/mpi.cpp:15 [5]).

Here both tiers live in one frozen dataclass so every engine sees the same
values and they are hashable/static under ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax.numpy as jnp

__all__ = ["SimConfig", "DEFAULTS"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Frozen, hashable configuration for one simulation run.

    Physics fields carry the reference's exact defaults; engine-tunable fields
    are the analog of the reference's per-backend macros.
    """

    # ---- physics constants (reference: part1/common.h:4-11) ----
    num_parts: int = 1000
    nsteps: int = 1000
    savefreq: int = 10
    density: float = 0.0005
    mass: float = 0.01
    cutoff: float = 0.01
    dt: float = 0.0005

    # ---- dimensionality (stretch config: 3D; the reference is 2D-only) ----
    # ``density`` generalizes to "box measure per particle": the box side is
    # (density * n)^(1/ndim), which reduces to the reference's
    # sqrt(density * n) in 2D (part1/main.cpp:113). Note the interacting-
    # neighbor count per particle is (4/3)pi cutoff^3 / density in 3D, so 3D
    # runs want a much smaller density than the 2D default to see collisions
    # (e.g. ~7e-6 for ~0.6 neighbors each, vs 0.628 at the 2D default).
    ndim: int = 2

    # ---- force law (plug-in seam; reference isolates apply_force the same
    # way, part1/serial.cpp:19-36) ----
    # "repulsive" = the reference's short-range repulsion; "lj" = truncated
    # Lennard-Jones. Both laws are supported by every engine, including the
    # step kernel (ops/pallas_grid._pair_coef) and the sharded engines.
    # Stable LJ demo parameters: r_min = 2^(1/6)*sigma ~ 0.0079 (the spacing
    # the repulsive law maintains) and a well shallow enough for dt <= 1e-4;
    # the r^-12 wall is far stiffer than the reference law, so LJ runs want
    # a smaller dt than the repulsive default of 5e-4.
    force_law: str = "repulsive"
    lj_epsilon: float = 1.0e-4
    lj_sigma: float = 0.007

    # ---- numerics ----
    # f32 is the default; the gather engines and the oracle/checker path can
    # run f64 (enable jax_enable_x64) for tight parity. The slab engines are
    # f32-only.
    dtype: str = "float32"

    # ---- engine tunables ----
    # Bin side length as a multiple of cutoff. Any value >= 1.0 keeps the
    # 3x3 neighbor-bin stencil correct. The reference used 1.0 (serial/gpu/mpi)
    # and 5.0 (vecmp); here a 2.0x bin quarters the bin count (fewer, denser
    # bins amortize the fixed per-bin padding of static shapes).
    bin_scale: float = 2.0
    # Max particles per bin (static capacity; analog of part3/gpu.cu:10's
    # MAX_PTS_PER_BIN=16). Overflow is *detected* here (the reference silently
    # corrupts on overflow, gpu.cu:109-111).
    bin_capacity: int = 8
    # Sharded engine: per-device particle-slot slack factor and per-step
    # emigrant-buffer capacity factor (analog of part2/mpi.cpp:15's
    # MAX_NUM_PTS_PER_BIN=5 fixed recv buffers).
    shard_slack: float = 1.5
    migrate_capacity: Optional[int] = None  # None -> derived from geometry

    # ---- dense slab-grid engine (the flagship perf engine) ----
    # Bin side (in cutoffs) for the slab-layout grid engine. Larger bins mean
    # fewer, fuller bins: less capacity-padding waste per pair-candidate.
    grid_bin_scale: float = 5.0
    # Slots per bin (slab count). With grid_bin_scale=5, mean occupancy is
    # grid_bin_scale^2 * cutoff^2 / density = 5.0; density fluctuations are
    # near-Poisson at this scale, so leave tail room (overflow backpressure
    # defers, never drops — but deferral costs transient force accuracy).
    # At 20M x 1000 steps cap 10 deferral-cascades into runaway speeds
    # (caught by the monitors); 11 runs clean (checker PASS). None = AUTO:
    # grid_ops.GRID_CAPACITY_DEFAULT = 11 (the lane snap derives its own
    # capacity from occupancy + headroom) AND the drop-detected
    # capacity-escalation retry stays armed
    # (engines/grid.py — the r5 2D port of the 3D self-heal, after the
    # 20.97M 2D LJ run outgrew capacity 14 mid-run). An explicit int is a
    # hand override and disables the retry (ablations and overflow tests
    # under-provision on purpose) — same contract as grid3_capacity.
    grid_capacity: Optional[int] = None
    # 3D slab grid (stretch config): mean occupancy is
    # (grid3_bin_scale*cutoff)^3 / density — at the 3D reference density
    # ~7e-6 and scale 3, ~3.9 per bin; capacity leaves Poisson tail room
    # (same deferral backpressure as 2D).
    grid3_bin_scale: float = 3.0
    # None = auto: Geometry3S.for_config picks the slot capacity (base 10
    # plus measured anisotropy/attractive-tail headroom — see the
    # calibration notes there). An explicit int is a hand override and
    # disables both the LJ capacity floor and the engines' drop-detected
    # capacity-escalation retry (engines/grid3d.py).
    grid3_capacity: Optional[int] = None
    # Deferral-style init spill (r5): when the t=0 packing exceeds the
    # capacity, move each overfull bin's boundary-proximate overflow into
    # the face-adjacent bin it is within the stale-slack budget of, instead
    # of raising capacity for the whole run (lane work scales ~capacity²;
    # the 20.97M 3D lattice packs ONE slot past the chooser capacity in
    # ~98k bins while the running rebin absorbs more via deferral — see
    # ops/grid3d_ops.slab3_from_particles_spill). None = auto: enabled for
    # auto capacity, disabled for hand grid3_capacity overrides (ablations
    # under-provision on purpose and must see the raise). True forces it on
    # even with a hand capacity; False disables. A spill that cannot place
    # everything falls back to the capacity raise, loss-free.
    grid3_spill: Optional[bool] = None
    # Snap the 3D grid's padded axes: choose per-axis bin sizes so the z bin
    # count lands on a multiple of 128 and x on a multiple of 8,
    # compensating occupancy with the other axes (bsx*bsy*bsz is held at
    # grid3_bin_size^3, so capacity stays valid). The physical bin count is
    # invariant at fixed occupancy — the padded (X, Z) planes are not: an
    # unsnapped cube pads z up to the next 128 (57% dead slots at n=16.8M,
    # 2x at 1M). The padding rule was chosen for another machine and awaits
    # a refit on the GPU. See Geometry3S.for_config.
    grid3_snap_lanes: bool = True
    # Assumed max particle speed for the 3D stale-slack feasibility bound
    # and the auto rebin cadence (observed max |v| ~ 3.8 at 1M-16.8M; the
    # runtime monitor still checks the MEASURED speed, engines/grid3d.py).
    grid3_vmax: float = 4.0
    # 3D rebin cadence (drift bound: cadence * max|v| * dt <= per-axis
    # slack (bin_side - cutoff)/2). None = auto from the chosen geometry's
    # tightest axis via Geometry3S.cadence (snapped axes have less slack
    # than the isotropic default's 0.01).
    rebin3_every: Optional[int] = None
    # Capacity-phase repack (3D): when the t=0 lattice packs more particles
    # into one bin than the chooser's run capacity (a step-0 transient — the
    # dynamics disperse the lattice within tens of steps), the timed drivers
    # run a short prologue at the raised packing capacity and then REPACK the
    # slab down to the run capacity (lane work scales ~capacity², so the
    # whole-run raise was a measured ~19-22% tax at the 20.97M 3D stretch
    # scale — r4 verdict #1). None = auto (on for laws whose run-tail
    # occupancy never exceeds the chooser capacity, i.e. repulsive; off for
    # LJ, whose demand grows over the run); False = never (ablations);
    # True = force-enable.
    grid3_repack: Optional[bool] = None
    # Steps before the first repack attempt (None = auto: the measured
    # lattice-dispersal scale, rounded up to the rebin cadence). Attempts
    # repeat at later program boundaries while steps_done stays within the
    # drivers' attempt window; a failed attempt (the low-capacity pack would
    # still overflow) keeps the run at the packing capacity — never drops.
    grid3_prologue_steps: Optional[int] = None
    # Rebin cadence in steps. Stale binning stays correct while accumulated
    # drift satisfies rebin_every * max|v| * dt <= (bin_side - cutoff) / 2;
    # monitored at runtime via max_speed.
    rebin_every: int = 8
    # Max particles leaving one bin in one direction per rebin; excess
    # defers to the next rebin (monitored).
    evac_capacity: int = 4
    # 2D rebin algorithm: "axes" (default) = the axis-factorized form (rows
    # pass then cols pass, the 2D port of the 3D design — 2 directions per
    # pass instead of 8); "dirs9" = the original 9-direction dense shuffle,
    # kept as an ablation. Both are loss-free under the same acceptance
    # contract; deferral decisions differ, so cross-variant trajectories
    # agree to f32 summation order.
    grid_rebin_mode: str = "axes"
    # Snap the 2D grid to a bin count on a multiple of 128 near the
    # default, with bin size size/m (exact cover -> zero padded cols) and
    # capacity following occupancy; a cost model picks the winner
    # (SlabGeometry.for_config, ops/grid_ops.py — the 2D analog of
    # grid3_snap_lanes). Its constants were fitted on another machine and
    # await a refit on the GPU; they change the physics schedule (bin size,
    # capacity), not only the speed. Grids narrower than 128 bins (all
    # tests) always keep the default geometry. `--grid-snap-lanes 0`
    # restores the scale-derived geometry exactly.
    grid_snap_lanes: bool = True

    # Initial slab packing rank computation, both grid families: "sort"
    # (argsort by bin — the default) or "claim" (sort-free scatter-min
    # rounds, bit-identical slab — see binning.claim_ranks).
    grid_pack_mode: str = "sort"

    # ---- derived geometry ----
    @property
    def size(self) -> float:
        """Box side length (reference: part1/main.cpp:113 for 2D)."""
        if self.ndim == 2:
            # math.sqrt exactly matches the C++ sqrt the native oracle uses
            # (bit-level trajectory parity); ** (1/2) is not guaranteed to.
            return math.sqrt(self.density * self.num_parts)
        return (self.density * self.num_parts) ** (1.0 / self.ndim)

    @property
    def min_r(self) -> float:
        """Minimum interaction distance (reference: part1/common.h:10)."""
        return self.cutoff / 100.0

    @property
    def bin_size(self) -> float:
        return self.bin_scale * self.cutoff

    @property
    def bins_per_side(self) -> int:
        """Bins per side (reference: part1/serial.cpp:78 ``ceil(size/BIN_SIZE)``)."""
        return max(1, math.ceil(self.size / self.bin_size))

    @property
    def num_bins(self) -> int:
        return self.bins_per_side * self.bins_per_side

    @property
    def grid_bin_size(self) -> float:
        return self.grid_bin_scale * self.cutoff

    @property
    def grid_bins_per_side(self) -> int:
        return max(1, math.ceil(self.size / self.grid_bin_size))

    @property
    def grid_slack(self) -> float:
        """Max tolerated position drift between rebins (stale-bin safety)."""
        return (self.grid_bin_size - self.cutoff) / 2.0

    @property
    def grid3_bin_size(self) -> float:
        return self.grid3_bin_scale * self.cutoff

    @property
    def grid3_bins_per_side(self) -> int:
        return max(1, math.ceil(self.size / self.grid3_bin_size))

    @property
    def law_params(self) -> tuple:
        """Static extra parameters of the active force law (hashable, passed
        straight through to the step kernel's _pair_coef seam)."""
        if self.force_law == "lj":
            return (self.lj_epsilon, self.lj_sigma)
        return ()

    def __post_init__(self):
        # float64 must be REAL when requested (SURVEY §7 names f64-vs-f32
        # validation a hard part; r3 verdict: the flag silently ran f32
        # because jax truncates f64 arrays unless x64 is enabled). The CLI
        # enables x64 itself (harness.main); direct library users get this
        # loud error instead of a silent truncation warning.
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype {self.dtype!r} "
                             "(float32 | float64)")
        if self.dtype == "float64":
            import jax

            if not jax.config.jax_enable_x64:
                raise RuntimeError(
                    "dtype='float64' requires x64 mode: call "
                    "jax.config.update('jax_enable_x64', True) before "
                    "building the config (the CLI does this for "
                    "--dtype float64). Without it JAX truncates every "
                    "array to float32."
                )

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    def with_(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.bin_scale < 1.0:
            raise ValueError(
                f"bin_scale={self.bin_scale} < 1: the 3x3 stencil would miss "
                "in-range pairs (bin side must be >= cutoff)."
            )
        if self.num_parts <= 0:
            raise ValueError("num_parts must be positive")
        if self.bin_capacity < 1:
            raise ValueError("bin_capacity must be >= 1")
        if self.grid_bin_scale <= 1.0:
            raise ValueError(
                f"grid_bin_scale={self.grid_bin_scale} must exceed 1: the grid "
                "engine needs positive stale-bin slack (bin side > cutoff)."
            )
        if self.rebin_every < 1 or self.evac_capacity < 1:
            raise ValueError("rebin_every / evac_capacity must be >= 1")
        if self.grid_capacity is not None and self.grid_capacity < 1:
            raise ValueError("grid_capacity must be >= 1 (or None for auto)")
        if self.grid_pack_mode not in ("sort", "claim"):
            raise ValueError(
                f"grid_pack_mode={self.grid_pack_mode!r}: must be 'sort' or "
                f"'claim'")
        if self.grid_rebin_mode not in ("dirs9", "axes"):
            raise ValueError(
                f"grid_rebin_mode={self.grid_rebin_mode!r}: must be 'dirs9' or 'axes'"
            )
        if self.grid3_bin_scale <= 1.0:
            raise ValueError(
                f"grid3_bin_scale={self.grid3_bin_scale} must exceed 1: the 3D "
                "grid engines need positive stale-bin slack (bin side > cutoff)."
            )
        if self.rebin3_every is not None and self.rebin3_every < 1:
            raise ValueError("rebin3_every must be >= 1 (or None for auto)")
        if self.grid3_capacity is not None and self.grid3_capacity < 1:
            raise ValueError("grid3_capacity must be >= 1 (or None for auto)")
        if self.grid3_prologue_steps is not None and self.grid3_prologue_steps < 1:
            raise ValueError(
                "grid3_prologue_steps must be >= 1 (or None for auto)")
        if self.force_law not in ("repulsive", "lj"):
            raise ValueError(
                f"unknown force_law {self.force_law!r}; have 'repulsive', 'lj'"
            )
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")


DEFAULTS = SimConfig()
