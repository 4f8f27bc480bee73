"""The Triton step kernel (ops/pallas_grid.py) on the CPU: interpret-mode
parity with the XLA twin (grid_force_xla + grid_move), the ghost-row path
the sharded engine uses, the explicit-interpret gate, and lowering to a
Triton custom call for CUDA at the headline width."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppsim_tpu.config import SimConfig
from ppsim_tpu.initlib import init_particles_fast
from ppsim_tpu.ops import grid_ops
from ppsim_tpu.ops.grid_ops import SlabGeometry
from ppsim_tpu.ops.pallas_grid import TILE_COLS, TILE_ROWS, grid_step_pallas
from ppsim_tpu.physics import accel_fn_for

VEL_TOL = 1e-5  # x max|v| (chip_smoke.py's bounds)
POS_TOL = 1e-6  # x bin size


def _config(law):
    kw = {"dt": 1e-4} if law == "lj" else {}
    return SimConfig(num_parts=600, grid_bin_scale=3.0, grid_capacity=6,
                     force_law=law, **kw)


def _geometry(cfg, layout):
    g = SlabGeometry.for_config(cfg)  # rows/cols padded to 8 / 128
    if layout == "ragged":
        g = dataclasses.replace(g, rows_pad=g.rows, cols_pad=g.cols)
        assert g.rows % TILE_ROWS and g.cols % TILE_COLS
    else:
        assert g.rows_pad % TILE_ROWS == 0 and g.cols_pad % TILE_COLS == 0
    return g


def _slab(cfg, geom):
    """Lattice init with every coordinate jittered by up to 0.8 cutoff, so
    the step has pairs inside the cutoff (the plain lattice has none)."""
    pos, vel = init_particles_fast(cfg.num_parts, cfg.size, 5)
    d = jax.random.uniform(jax.random.PRNGKey(6), pos.shape, jnp.float32,
                           -0.8 * cfg.cutoff, 0.8 * cfg.cutoff)
    pos = jnp.clip(pos + d, 0.0, cfg.size)
    slab, _ = grid_ops.slab_from_particles(pos, vel, geom)
    return slab


def _twin(cfg, geom, slab):
    acc = grid_ops.grid_force_xla(slab.xl, slab.yl, geom, cfg.cutoff,
                                  cfg.min_r, cfg.mass,
                                  pair_fn=accel_fn_for(cfg))
    new, _ = grid_ops.grid_move(slab, acc, geom, cfg.dt, cfg.size)
    sp = jnp.where(new.pid >= 0, new.vx ** 2 + new.vy ** 2, 0.0).max(axis=0)
    return new, sp


@pytest.mark.parametrize("ghosts", [False, True], ids=["whole", "strip"])
@pytest.mark.parametrize("layout", ["aligned", "ragged"])
@pytest.mark.parametrize("law", ["repulsive", "lj"])
def test_kernel_matches_xla_twin(law, layout, ghosts):
    """One fused step against the XLA twin. ``strip`` runs the kernel on a
    middle band of rows with the neighbouring rows passed as ghosts and the
    band's global row offset as ``row0`` — the sharded engine's call."""
    cfg = _config(law)
    geom = _geometry(cfg, layout)
    slab = _slab(cfg, geom)
    ref, rsp = _twin(cfg, geom, slab)
    assert int((np.abs(np.asarray(ref.vx)) > 0).sum()) > 0
    fields = (slab.xl, slab.yl, slab.vx, slab.vy)
    kw = dict(interpret=True, law=cfg.force_law, law_params=cfg.law_params)
    R = fields[0].shape[1]
    if ghosts:
        a, b = 3, R - 6  # a band whose height is not a tile multiple
        assert (b - a) % TILE_ROWS
        kw.update(row0=a, ghosts=(slab.xl[:, a - 1:a], slab.yl[:, a - 1:a],
                                  slab.xl[:, b:b + 1], slab.yl[:, b:b + 1]))
        fields = tuple(f[:, a:b] for f in fields)
        ref = ref._replace(**{k: getattr(ref, k)[:, a:b]
                              for k in ("xl", "yl", "vx", "vy")})
        rsp = rsp[a:b]
    out = grid_step_pallas(*fields, geom, cfg.cutoff, cfg.min_r, cfg.mass,
                           cfg.dt, cfg.size, **kw)
    vmax = float(jnp.abs(jnp.stack([ref.vx, ref.vy])).max())
    for name, got, want, tol in (
            ("xl", out[0], ref.xl, POS_TOL * geom.bin_size),
            ("yl", out[1], ref.yl, POS_TOL * geom.bin_size),
            ("vx", out[2], ref.vx, VEL_TOL * vmax),
            ("vy", out[3], ref.vy, VEL_TOL * vmax),
            ("speed", jnp.sqrt(out[4]), jnp.sqrt(rsp), VEL_TOL * vmax)):
        assert got.shape == want.shape, name
        err = float(jnp.abs(got - want).max())
        assert err <= tol, (name, err, tol)


def test_kernel_engines_need_gpu_or_explicit_interpret(tiny_grid_config):
    """No implicit interpreter: off a GPU the kernel engines refuse to
    build unless interpret=True is passed; the XLA impl needs neither."""
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.engines.sharded_grid import ShardedGridEngine

    cfg = tiny_grid_config
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="GPU"):
        get_engine("pallas", cfg)
    with pytest.raises(RuntimeError, match="GPU"):
        ShardedGridEngine(cfg, devices=jax.devices()[:2])
    assert get_engine("pallas", cfg, interpret=True).interpret
    ShardedGridEngine(cfg, devices=jax.devices()[:2], impl="xla")


@pytest.mark.parametrize("ghosts", [False, True], ids=["whole", "strip"])
def test_kernel_lowers_to_triton_at_headline_width(ghosts):
    """Pallas -> Triton lowering for CUDA runs on the CPU too: the kernel at
    the 20.97M geometry (1664 x 1664 bins, capacity 14) must lower to one
    Triton custom call (what Triton's own compiler then accepts shows only
    on the card)."""
    cfg = SimConfig(num_parts=20_971_520)
    geom = SlabGeometry.for_config(cfg)
    assert (geom.rows_pad, geom.cols_pad, geom.capacity) == (1664, 1664, 14)
    plane = jax.ShapeDtypeStruct(geom.shape, jnp.float32)
    ghost = jax.ShapeDtypeStruct((geom.capacity, 1, geom.cols_pad),
                                 jnp.float32)

    def step(xl, yl, vx, vy, *g):
        return grid_step_pallas(xl, yl, vx, vy, geom, cfg.cutoff, cfg.min_r,
                                cfg.mass, cfg.dt, cfg.size,
                                row0=7 if ghosts else None,
                                ghosts=g if ghosts else None)

    exp = jax.export.export(
        jax.jit(step), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(*([plane] * 4 + ([ghost] * 4 if ghosts else [])))
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert [o.shape for o in exp.out_avals] == [geom.shape] * 4 + [
        (geom.rows_pad, geom.cols_pad)]
