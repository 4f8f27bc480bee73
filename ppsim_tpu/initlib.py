"""Particle initialization.

The reference initializer (``init_particles``, part1/main.cpp:31-59) places
particles on a shuffled ceil(sqrt(N)) x sy lattice and draws velocities
uniformly from [-1, 1), using ``std::mt19937`` with a partial Fisher-Yates
draw for the lattice-cell assignment. Positions use
``uniform_int_distribution<int>``; velocities use
``uniform_real_distribution<float>`` (float, not double —
part1/main.cpp:55-57). The MPI variant additionally stamps 1-based ids
(part2/main.cpp:61-63); here ids are implicit array indices.

Two initializers are provided:

- :func:`init_particles_reference` — bit-faithful numpy reimplementation of
  the libstdc++ ``mt19937`` + distribution semantics, so trajectories can be
  cross-checked against native binaries built from the same seed. Pure
  Python/numpy draw loop; intended for n up to ~1M (tests, parity checks).
- :func:`init_particles_fast` — ``jax.random``-based initializer with the
  same lattice structure and velocity distribution (statistically equivalent,
  not bit-identical); scales to tens of millions of particles on device.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ppsim_tpu.config import SimConfig
from ppsim_tpu.state import ParticleState, make_state

__all__ = [
    "MT19937",
    "init_particles_reference",
    "init_particles_fast",
    "init_particles",
]


class MT19937:
    """Minimal MT19937 engine matching ``std::mt19937`` (single-value seed).

    Seeding follows the C++11 mersenne_twister_engine seed algorithm:
    x[0]=seed; x[i] = 1812433253*(x[i-1] ^ (x[i-1]>>30)) + i (mod 2^32).
    Blocks of 624 outputs are generated with vectorized numpy tempering.
    """

    N, M = 624, 397
    MATRIX_A = np.uint32(0x9908B0DF)
    UPPER = np.uint32(0x80000000)
    LOWER = np.uint32(0x7FFFFFFF)

    def __init__(self, seed: int):
        x = np.empty(self.N, dtype=np.uint64)
        x[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            x[i] = (1812433253 * (x[i - 1] ^ (x[i - 1] >> np.uint64(30))) + i) & 0xFFFFFFFF
        self._state = x.astype(np.uint32)
        self._buf = np.empty(0, dtype=np.uint32)
        self._pos = 0

    def _twist(self) -> np.ndarray:
        # The generation pass updates the state IN PLACE: iteration i reads
        # x[i+M mod N] and (for the final element) x[0] *after* they were
        # rewritten by earlier iterations. Vectorize in dependency-safe
        # chunks: the first N-M elements read only old state; the rest read
        # new values with lag N-M, so chunks of that size stay consistent.
        x = self._state
        N, M = self.N, self.M
        one = np.uint32(1)

        def gen(y, src):
            mag = np.where((y & one).astype(bool), self.MATRIX_A, np.uint32(0))
            return src ^ (y >> one) ^ mag

        nxt = np.empty_like(x)
        y = (x[0 : N - M] & self.UPPER) | (x[1 : N - M + 1] & self.LOWER)
        nxt[0 : N - M] = gen(y, x[M:N])
        start = N - M
        while start < N - 1:
            end = min(N - 1, start + (N - M))
            y = (x[start:end] & self.UPPER) | (x[start + 1 : end + 1] & self.LOWER)
            nxt[start:end] = gen(y, nxt[start + M - N : end + M - N])
            start = end
        y = (x[N - 1] & self.UPPER) | (nxt[0] & self.LOWER)
        nxt[N - 1] = gen(y, nxt[M - 1])
        self._state = nxt
        # temper
        z = nxt.copy()
        z ^= z >> np.uint32(11)
        z ^= (z << np.uint32(7)) & np.uint32(0x9D2C5680)
        z ^= (z << np.uint32(15)) & np.uint32(0xEFC60000)
        z ^= z >> np.uint32(18)
        return z

    def fill(self, count: int) -> None:
        """Ensure at least ``count`` un-consumed outputs are buffered."""
        chunks = [self._buf[self._pos :]]
        have = chunks[0].shape[0]
        while have < count:
            c = self._twist()
            chunks.append(c)
            have += c.shape[0]
        self._buf = np.concatenate(chunks)
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos >= self._buf.shape[0]:
            self.fill(self.N)
        v = int(self._buf[self._pos])
        self._pos += 1
        return v


def _uniform_int(gen: MT19937, upper: int) -> int:
    """libstdc++ ``uniform_int_distribution<int>(0, upper)`` downscaling path.

    (bits/uniform_int_dist.h: scaling = floor((2^32-1)/(upper+1)); draw until
    below ``(upper+1)*scaling``; divide.)
    """
    urngrange = 0xFFFFFFFF
    uerange = upper + 1
    scaling = urngrange // uerange
    past = uerange * scaling
    while True:
        r = gen.next_u32()
        if r < past:
            return r // scaling


def _uniform_float_pm1(gen: MT19937) -> np.float32:
    """libstdc++ ``uniform_real_distribution<float>(-1, 1)``.

    generate_canonical<float, 24> with mt19937 consumes one draw:
    ``c = float(u) / float(2^32)`` in float arithmetic, clamped below 1;
    result = ``c * 2.0f + (-1.0f)``.
    """
    u = gen.next_u32()
    c = np.float32(np.float32(u) / np.float32(4294967296.0))
    if c >= np.float32(1.0):
        c = np.nextafter(np.float32(1.0), np.float32(0.0))
    return np.float32(c * np.float32(2.0) + np.float32(-1.0))


def init_particles_reference(num_parts: int, size: float, seed: int):
    """Bit-faithful reimplementation of the reference ``init_particles``.

    (part1/main.cpp:31-59.) Returns float64 numpy arrays ``pos, vel`` of
    shape (N, 2) matching the C++ trajectory's step-0 state bit-for-bit.
    ``seed`` must be nonzero (the reference falls back to random_device for
    seed 0, which is inherently irreproducible).
    """
    if seed == 0:
        raise ValueError("seed 0 means 'nondeterministic' in the reference; pick a nonzero seed")
    from ppsim_tpu import native

    if native.available():
        # Bit-identical C++ implementation (native/ppsim_native.cpp
        # ppsim_init_particles; parity-pinned by
        # tests/test_native.py::test_native_init_matches_python_mt19937) —
        # ~20 s at n=20.97M on this host vs hours for the Python loop.
        return native.native_init(num_parts, size, seed)
    gen = MT19937(seed)
    gen.fill(max(num_parts * 4, 1024))

    sx = int(math.ceil(math.sqrt(float(num_parts))))
    sy = (num_parts + sx - 1) // sx

    shuffle = np.arange(num_parts, dtype=np.int64)
    pos = np.empty((num_parts, 2), dtype=np.float64)
    vel = np.empty((num_parts, 2), dtype=np.float64)

    for i in range(num_parts):
        j = _uniform_int(gen, num_parts - i - 1)
        k = int(shuffle[j])
        shuffle[j] = shuffle[num_parts - i - 1]

        pos[i, 0] = size * (1.0 + (k % sx)) / (1 + sx)
        pos[i, 1] = size * (1.0 + (k // sx)) / (1 + sy)

        vel[i, 0] = float(_uniform_float_pm1(gen))
        vel[i, 1] = float(_uniform_float_pm1(gen))

    return pos, vel


import functools


# Above this n, the "fast" initializer computes on the host CPU backend: init
# is OUTSIDE the timing contract, and the H2D transfer it adds is one the
# contract already pays (harness device_puts the state before the timer).
# jax.random is bitwise deterministic across backends, so the values are
# identical either way — chip_smoke.py checks that on the GPU at 20.97M.
_FAST_HOST_N = 4_000_000


def init_particles_fast(num_parts: int, size: float, seed: int,
                        dtype=jnp.float32, ndim: int = 2,
                        host: bool = None):
    """Device-side initializer, statistically equivalent to the reference.

    Same lattice geometry and shuffled (spatially unsorted) cell assignment as
    part1/main.cpp:31-59, same U[-1,1) velocity law, but driven by
    ``jax.random`` so it runs on-device at any scale (jitted: per-op eager
    dispatch would cost one program launch per op).
    ``ndim=3`` generalizes the lattice to ceil(N^(1/3))^2 x sz cells (the
    reference is 2D-only; this is the stretch-config analog).

    ``host``: pin the computation to the CPU backend (None = auto: big n
    only, see ``_FAST_HOST_N``). Values are identical on either backend.
    """
    if host is None:
        host = num_parts > _FAST_HOST_N
    if host:
        try:
            cpu = jax.devices("cpu")[0]
        except RuntimeError:
            cpu = None
        if cpu is not None and jax.devices()[0] != cpu:
            with jax.default_device(cpu):
                return _init_fast_jit(num_parts, size, seed, dtype, ndim)
    return _init_fast_jit(num_parts, size, seed, dtype, ndim)


@functools.partial(
    jax.jit, static_argnames=("num_parts", "size", "seed", "dtype", "ndim")
)
def _init_fast_jit(num_parts: int, size: float, seed: int,
                   dtype=jnp.float32, ndim: int = 2):
    key = jax.random.PRNGKey(seed)
    k_perm, k_vel = jax.random.split(key)
    k = jax.random.permutation(k_perm, num_parts)

    if ndim == 2:
        sx = int(math.ceil(math.sqrt(float(num_parts))))
        sy = (num_parts + sx - 1) // sx
        coords = []
        for idx, s in ((k % sx, sx), (k // sx, sy)):
            coords.append(
                jnp.asarray(size, dtype) * (1.0 + idx.astype(dtype)) / (1 + s)
            )
    else:
        sx = int(math.ceil(float(num_parts) ** (1.0 / 3.0)))
        sy = sx
        sz = (num_parts + sx * sy - 1) // (sx * sy)
        coords = []
        for idx, s in ((k % sx, sx), ((k // sx) % sy, sy), (k // (sx * sy), sz)):
            coords.append(
                jnp.asarray(size, dtype) * (1.0 + idx.astype(dtype)) / (1 + s)
            )
    pos = jnp.stack(coords, axis=-1)
    vel = jax.random.uniform(
        k_vel, (num_parts, ndim), dtype=dtype, minval=-1.0, maxval=1.0
    )
    return pos, vel


def init_particles(config: SimConfig, seed: int, method: str = "auto") -> ParticleState:
    """Build the initial :class:`ParticleState` for a config.

    ``method``: ``"reference"`` (bit-faithful, host), ``"fast"`` (device), or
    ``"auto"`` (reference for small n where the host loop is cheap, else fast).
    """
    if method == "auto":
        # Prefer the bit-faithful reference init wherever it exists (2D,
        # nonzero seed): with the native library it is cheap at any n, and
        # it keeps the CLI's `-s`-seeded step-0 state bit-identical to the
        # C++ reference. Without the native library the Python MT19937 loop
        # is only affordable at small n.
        from ppsim_tpu import native

        big = config.num_parts > 100_000 and not native.available()
        method = (
            "reference"
            if (seed != 0 and config.ndim == 2 and not big)
            else "fast"
        )
    if method == "reference":
        if config.ndim != 2:
            raise ValueError(
                "the bit-faithful reference initializer is 2D-only (there is "
                "no C++ reference to match in 3D); use method='fast'"
            )
        pos, vel = init_particles_reference(config.num_parts, config.size, seed)
    elif method == "fast":
        pos, vel = init_particles_fast(
            config.num_parts, config.size, seed, ndim=config.ndim
        )
    else:
        raise ValueError(f"unknown init method {method!r}")
    return make_state(pos, vel, dtype=config.jnp_dtype)
