"""Pallas kernel (Triton route) for the slab-grid fused force+move step.

The force phase is 75% of the reference's step time (part3 write-up §6
nvprof: ``compute_forces_gpu`` 74.85%), so it gets the hand-written kernel —
the analog of part3/gpu.cu:115-142's thread-per-bin CUDA kernel, with each
element of a program's tile playing the role of one CUDA thread's bin.

Formulation: state fields are (capacity, R, C) slot-slab planes with
bin-local positions (see :mod:`ppsim_tpu.ops.grid_ops`). Each program owns a
``(TILE_ROWS, TILE_COLS)`` tile of bins and writes only its own bins, so the
kernel needs no atomics and is deterministic:

- the tile's own ``capacity`` slots (positions, velocities) are loaded once
  and stay in registers beside ``2 x capacity`` acceleration accumulators;
- the 3x3 neighbourhood is read slot by slot with masked loads from the
  full arrays (``other=BIG``: off-grid neighbours are empty slots, exactly
  the XLA twin's ``_shifted`` fill). Ghost rows from the sharded engine's
  halo exchange stand in for rows -1 and R;
- every pair is evaluated from both sides (9 x cap^2 pair evaluations per
  bin, the reference's one-way scheme), so no program writes another's bins;
- the Verlet move and wall reflection run on the accumulators in registers,
  and the kernel emits the per-bin max |v|^2 plane for the stale-slack
  monitor.

Empty slots hold the ``BIG`` sentinel and fail the cutoff test like any far
particle; slot aliveness is derived from that same sentinel, so the pid
planes never enter the kernel.

The XLA twin is ``grid_ops.grid_force_xla`` followed by ``grid_ops.grid_move``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ppsim_tpu.ops.binning import BIG
from ppsim_tpu.ops.grid_ops import SlabGeometry

__all__ = ["grid_step_pallas", "require_gpu", "TILE_ROWS", "TILE_COLS",
           "NUM_WARPS"]

# Tile of bins per program and warps per program. Triton blocks are powers
# of two; at capacity 14 a thread holds 4 x capacity live values per bin it
# owns (positions and accumulators), so register pressure bounds the tile.
TILE_ROWS = 4
TILE_COLS = 32
NUM_WARPS = 4


def require_gpu(interpret: bool) -> None:
    """Refuse to build a kernel engine that could only run interpreted.

    The kernel is compiled by Triton for an NVIDIA GPU. Anywhere else it
    runs only in the Pallas interpreter, which must be asked for
    explicitly (``interpret=True``, as the CPU tests do)."""
    platform = jax.default_backend()
    if not interpret and platform != "gpu":
        raise RuntimeError(
            f"the Triton step kernel needs an NVIDIA GPU, but JAX's default "
            f"backend is {platform!r}; pass interpret=True (CLI: "
            "--interpret) to run it in the Pallas interpreter, or use the "
            "XLA engines (grid, sharded_grid impl='xla')")


def _pair_coef(r2, cutoff, min_r, mass, law, law_params):
    """Pair coefficient: acceleration contribution = coef * (dx, dy).

    The force-law seam of the kernel — the plug-in point the reference
    isolates as ``apply_force`` (part1/serial.cpp:19-36) and the XLA engines
    expose via physics.accel_fn_for. ``law``/``law_params`` are static, so
    each law compiles to its own straight-line code:

    - ``"repulsive"``: coef = (1 - cutoff/r) / r^2 / mass, factored as
      u - cutoff*(rinv*u) with u = rinv^2/mass.
    - ``"lj"``: truncated Lennard-Jones,
      coef = -24 eps (2 (sigma/r)^12 - (sigma/r)^6) / r^2 / mass
      (physics.lj_coef_from_r2 twin), ``law_params = (eps, sigma)``.

    Both laws share the reference's min_r distance clamp and contribute
    exactly 0 outside the cutoff (BIG-sentinel slots fail that test for free).
    """
    c2 = jnp.float32(cutoff * cutoff)
    mr2 = jnp.float32(min_r * min_r)
    r2c = jnp.maximum(r2, mr2)
    if law == "repulsive":
        rinv = jax.lax.rsqrt(r2c)
        u = jnp.float32(1.0 / mass) * (rinv * rinv)
        coef = u - jnp.float32(cutoff) * (rinv * u)
    elif law == "lj":
        eps, sigma = law_params
        inv = 1.0 / r2c
        s2 = jnp.float32(sigma * sigma) * inv
        s6 = s2 * s2 * s2
        coef = jnp.float32(-24.0 * eps / mass) * (s6 * (2.0 * s6 - 1.0)) * inv
    else:
        raise ValueError(f"unknown force_law {law!r}")
    return jnp.where(r2 <= c2, coef, 0.0)


def _reflect(local, off, v, L):
    """Wall reflection of one axis (grid_ops.grid_move's ``reflect``)."""
    g = local + off
    out = (g < 0.0) | (g > L)
    m = jnp.mod(g, 2.0 * L)
    local = jnp.where(out, (L - jnp.abs(m - L)) - off, local)
    v = jnp.where(out & (m > L), -v, v)
    return local, v


def _step_kernel(x_ref, y_ref, vx_ref, vy_ref, row0_ref, *rest, cap, br, bc,
                 bin_size, cutoff, min_r, mass, dt, size, law, law_params,
                 has_ghosts):
    gxt, gyt, gxb, gyb = rest[:4] if has_ghosts else (None,) * 4
    xo_ref, yo_ref, vxo_ref, vyo_ref, spo_ref = rest[4 if has_ghosts else 0:]
    R, C = x_ref.shape[1], x_ref.shape[2]
    r0 = pl.program_id(0) * br
    c0 = pl.program_id(1) * bc
    rows = r0 + jax.lax.broadcasted_iota(jnp.int32, (br, bc), 0)
    cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (br, bc), 1)
    inside = (rows < R) & (cols < C)
    own = (pl.ds(r0, br), pl.ds(c0, bc))

    def load_own(ref, s, fill):
        return plgpu.load(ref.at[(s,) + own], mask=inside, other=fill)

    xs = [load_own(x_ref, s, BIG) for s in range(cap)]
    ys = [load_own(y_ref, s, BIG) for s in range(cap)]
    bs = jnp.float32(bin_size)

    def neighbour(ref, top_ref, bot_ref, j, nrows, ncols, col_ok):
        """Slot j of the neighbour bins at (nrows, ncols); off-grid -> BIG.
        Rows -1 and R come from the ghost rows when the caller has them."""
        val = plgpu.load(ref.at[j, nrows, ncols],
                         mask=col_ok & (nrows >= 0) & (nrows < R), other=BIG)
        if has_ghosts:
            zero = jnp.zeros_like(nrows)
            top = plgpu.load(top_ref.at[j, zero, ncols],
                             mask=col_ok & (nrows == -1), other=BIG)
            bot = plgpu.load(bot_ref.at[j, zero, ncols],
                             mask=col_ok & (nrows == R), other=BIG)
            val = jnp.where(nrows == -1, top, jnp.where(nrows == R, bot, val))
        return val

    acc = tuple(jnp.zeros((br, bc), jnp.float32) for _ in range(2 * cap))
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            nrows = rows + dr
            ncols = cols + dc
            col_ok = (ncols >= 0) & (ncols < C)
            offx = jnp.float32(dr * bin_size)
            offy = jnp.float32(dc * bin_size)

            def body(j, acc, nrows=nrows, ncols=ncols, col_ok=col_ok,
                     offx=offx, offy=offy):
                xn = neighbour(x_ref, gxt, gxb, j, nrows, ncols, col_ok) + offx
                yn = neighbour(y_ref, gyt, gyb, j, nrows, ncols, col_ok) + offy
                out = list(acc)
                for s in range(cap):
                    dx = xn - xs[s]
                    dy = yn - ys[s]
                    coef = _pair_coef(dx * dx + dy * dy, cutoff, min_r, mass,
                                      law, law_params)
                    out[s] = out[s] + coef * dx
                    out[cap + s] = out[cap + s] + coef * dy
                return tuple(out)

            acc = jax.lax.fori_loop(0, cap, body, acc)

    # Verlet + wall reflection on the accumulators (reference:
    # serial.cpp:44-61; XLA twin: grid_ops.grid_move).
    dtf = jnp.float32(dt)
    L = jnp.float32(size)
    row_off = (row0_ref[0] + rows).astype(jnp.float32) * bs
    col_off = cols.astype(jnp.float32) * bs
    sp = jnp.zeros((br, bc), jnp.float32)
    for s in range(cap):
        alive = xs[s] < jnp.float32(0.5 * BIG)
        vx = jnp.where(alive, load_own(vx_ref, s, 0.0) + acc[s] * dtf, 0.0)
        vy = jnp.where(alive, load_own(vy_ref, s, 0.0) + acc[cap + s] * dtf,
                       0.0)
        xl, vx = _reflect(xs[s] + vx * dtf, row_off, vx, L)
        yl, vy = _reflect(ys[s] + vy * dtf, col_off, vy, L)
        plgpu.store(xo_ref.at[(s,) + own], jnp.where(alive, xl, BIG),
                    mask=inside)
        plgpu.store(yo_ref.at[(s,) + own], jnp.where(alive, yl, BIG),
                    mask=inside)
        plgpu.store(vxo_ref.at[(s,) + own], vx, mask=inside)
        plgpu.store(vyo_ref.at[(s,) + own], vy, mask=inside)
        # dead slots hold vx = vy = 0, matching grid_move's alive-masked
        # speed2 exactly
        sp = jnp.maximum(sp, vx * vx + vy * vy)
    plgpu.store(spo_ref.at[own], sp, mask=inside)


@functools.partial(
    jax.jit,
    static_argnames=("geom", "cutoff", "min_r", "mass", "dt", "size",
                     "interpret", "law", "law_params"),
)
def grid_step_pallas(xl, yl, vx, vy, geom: SlabGeometry,
                     cutoff, min_r, mass, dt, size, interpret=False,
                     row0=None, ghosts: Optional[Tuple] = None,
                     law="repulsive", law_params=()):
    """Fused force+move step. Returns (xl', yl', vx', vy', speed2) where
    ``speed2`` is an (R, C) plane of per-bin max |v|^2 over slots — reduce
    with ``jnp.sqrt(speed2.max())`` for the stale-slack monitor (computed
    in-kernel so the monitor costs no extra pass over the velocities).

    ``row0``: traced global row index of this array's first row (the
    sharded engine passes ``axis_index * rows_local``; default 0).
    ``ghosts``: optional (top_xl, top_yl, bot_xl, bot_yl), each (cap, 1, C) —
    the neighbour strips' boundary rows (sharded halo exchange); without
    them rows -1 and R are empty.
    Any array shape works: edge tiles are masked.
    """
    cap = geom.capacity
    _, R, C = xl.shape
    br, bc = TILE_ROWS, TILE_COLS
    row0 = jnp.zeros((1,), jnp.int32) + (0 if row0 is None else row0)
    extra = list(ghosts) if ghosts is not None else []
    kernel = functools.partial(
        _step_kernel, cap=cap, br=br, bc=bc, bin_size=geom.bin_size,
        cutoff=cutoff, min_r=min_r, mass=mass, dt=dt, size=size,
        law=law, law_params=law_params, has_ghosts=ghosts is not None,
    )
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    nin = 5 + len(extra)
    out = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(R, br), pl.cdiv(C, bc)),
        in_specs=[any_spec] * nin,
        out_specs=[any_spec] * 5,
        out_shape=[jax.ShapeDtypeStruct((cap, R, C), jnp.float32)] * 4
        + [jax.ShapeDtypeStruct((R, C), jnp.float32)],
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name="grid_step",
    )(xl, yl, vx, vy, row0, *extra)
    return tuple(out)
