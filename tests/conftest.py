"""Test harness setup: an 8-device CPU mesh, always.

The reference could only test its MPI engine on a real SLURM cluster
(part2/job-mpi); here the sharded engine's collectives run on XLA's forced
host-platform device mesh so the full multi-device code path is exercised
in CI with no accelerator attached (SURVEY.md §4).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppsim_tpu.testing import force_cpu_devices

force_cpu_devices(8)

import pytest  # noqa: E402

from ppsim_tpu.config import SimConfig  # noqa: E402


@pytest.fixture
def small_config():
    return SimConfig(num_parts=500)


@pytest.fixture
def grid_test_config():
    # Small caps keep the unrolled rebin graph cheap to compile on CPU.
    return SimConfig(
        num_parts=1000, grid_bin_scale=3.0, grid_capacity=6, evac_capacity=2,
        rebin_every=4,
    )


@pytest.fixture
def tiny_grid_config():
    # Tiny n + capacity keep the interpreted step kernel cheap enough for
    # the FAST suite: the 2-minute gate must exercise the flagship engines
    # too, not only the sort-binned ones.
    return SimConfig(
        num_parts=200, grid_bin_scale=3.0, grid_capacity=6, evac_capacity=2,
        rebin_every=4,
    )
