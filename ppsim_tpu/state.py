"""Particle state as a structure-of-arrays JAX pytree.

The reference keeps an array-of-structs ``particle_t {x,y,vx,vy,ax,ay}``
(part1/common.h:14-21; part2/common.h:17-25 prepends a ``uint64_t id``).
On an accelerator the natural layout is structure-of-arrays: one ``(N, 2)`` array per
quantity, so every physics op is a dense vector op over lanes.

Accelerations are *not* carried in the state: the reference zeroes them at the
start of every force phase (part1/serial.cpp:105, part2/mpi.cpp:216), so they
are pure per-step temporaries — recomputed inside the step function here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ParticleState", "make_state"]


class ParticleState(NamedTuple):
    """SoA particle state. ``pos``/``vel`` have shape (N, ndim) — (x, y) in
    the reference's 2D physics, (x, y, z) in the 3D stretch config."""

    pos: jax.Array  # (N, ndim) positions
    vel: jax.Array  # (N, ndim) velocities

    @property
    def num_parts(self) -> int:
        return self.pos.shape[0]

    @property
    def dtype(self):
        return self.pos.dtype

    def astype(self, dtype) -> "ParticleState":
        return ParticleState(self.pos.astype(dtype), self.vel.astype(dtype))

    def to_numpy(self):
        return np.asarray(self.pos), np.asarray(self.vel)


def make_state(pos, vel, dtype=None) -> ParticleState:
    pos = jnp.asarray(pos)
    vel = jnp.asarray(vel)
    if dtype is not None:
        pos = pos.astype(dtype)
        vel = vel.astype(dtype)
    if pos.shape != vel.shape or pos.ndim != 2 or pos.shape[1] not in (2, 3):
        raise ValueError(
            f"expected (N, 2) or (N, 3) pos/vel, got {pos.shape} / {vel.shape}"
        )
    return ParticleState(pos, vel)
