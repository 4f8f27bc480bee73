"""Test/bench environment helpers.

The reference could only validate its MPI engine on a real cluster via
``srun`` (part2/job-mpi) — there was no way to test multi-rank logic locally.
:func:`force_cpu_devices` turns the host into an N-device CPU mesh (XLA's
forced host-platform device count), so the sharded engines' collectives run
and are checked without any accelerator attached.

Must be called before JAX initializes its backends.
"""

from __future__ import annotations

import os

__all__ = ["force_cpu_devices"]


def force_cpu_devices(n: int = 8) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    want = f"--xla_force_host_platform_device_count={n}"
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " " + want).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    ndev = len(jax.devices())
    if ndev != n:
        raise RuntimeError(
            f"requested {n} CPU devices but got {ndev}; force_cpu_devices must "
            "run before JAX backend initialization"
        )
