"""CLI harness tests (reference flag surface: part1/main.cpp:95-117)."""

import json

import numpy as np
import pytest

from ppsim_tpu.harness import build_parser, main
from ppsim_tpu.io import read_trajectory


def test_default_flags():
    args = build_parser().parse_args([])
    assert args.n == 1000 and args.s == 0 and args.o is None


@pytest.mark.parametrize(
    "engine", ["binned", "grid", "pallas", "sharded", "sharded_grid"]
)
def test_cli_run_saves_and_checks(tmp_path, capsys, engine):
    """The -o/--check path must work (and PASS the checker) on every engine —
    the reference exercises its save path in every job script; round 1 only
    covered `binned` here."""
    out = str(tmp_path / "traj.txt")
    metrics = str(tmp_path / "m.jsonl")
    # the kernel engines run in the Pallas interpreter without a GPU, and
    # only when asked to
    interpret = ["--interpret"] if engine in ("pallas", "sharded_grid") else []
    rc = main(
        ["-n", "300", "-s", "42", "-o", out, "--steps", "40", "--check",
         "--metrics", metrics, "--engine", engine, "--savefreq", "8",
         # small grid config keeps CPU compiles of the unrolled rebin graphs
         # cheap (ignored by the sort-binned engines)
         "--grid-bin-scale", "3.0", "--grid-capacity", "6", "--rebin-every", "4"]
        + interpret
    )
    assert rc == 0
    stdout = capsys.readouterr().out
    assert "Simulation Time = " in stdout
    assert "seconds for 300 particles." in stdout
    assert "PASS" in stdout

    frames, size = read_trajectory(out)
    assert frames.shape == (5, 300, 2)  # saves at steps 1,9,17,25,33

    rec = json.loads(open(metrics).read().strip().split("\n")[-1])
    assert rec["num_parts"] == 300
    assert rec["particle_steps_per_sec"] > 0


@pytest.mark.parametrize("engine", ["grid3d"])
def test_cli_run_3d_saves_and_checks(tmp_path, capsys, engine):
    """3D engines must be drivable (and tunable) through the CLI — round 2
    never exercised any 3D engine here. steps < rebin cadence keeps the 3D
    rebin program (minutes-long XLA compile on a 1-core host) out of the
    fast suite; the full-run 3D paths are covered by slow-marked tests."""
    out = str(tmp_path / "traj3.txt")
    rc = main(
        ["-n", "160", "-s", "42", "-o", out, "--steps", "3", "--check",
         "--ndim", "3", "--engine", engine, "--savefreq", "1",
         "--grid-capacity", "8", "--rebin-every", "4"]
    )
    assert rc == 0
    stdout = capsys.readouterr().out
    assert "seconds for 160 particles." in stdout
    assert "PASS" in stdout
    frames, size = read_trajectory(out)
    assert frames.shape == (3, 160, 3)


def test_cli_grid_flags_route_to_active_family():
    """--grid-capacity / --rebin-every / --grid-bin-scale must tune the 3D
    fields under --ndim 3 (they were silently ignored in round 2); the
    explicit --grid3-* spellings win on conflict."""
    from ppsim_tpu.harness import config_from_args

    p = build_parser()
    cfg = config_from_args(p.parse_args(
        ["--ndim", "3", "--grid-capacity", "6", "--rebin-every", "3",
         "--grid-bin-scale", "2.5"]
    ))
    assert cfg.grid3_capacity == 6
    assert cfg.rebin3_every == 3
    assert cfg.grid3_bin_scale == 2.5
    # 2D fields untouched
    assert cfg.grid_capacity is None and cfg.rebin_every == 8  # None = auto

    cfg = config_from_args(p.parse_args(
        ["--ndim", "3", "--grid-capacity", "6", "--grid3-capacity", "9"]
    ))
    assert cfg.grid3_capacity == 9  # explicit spelling wins

    cfg = config_from_args(p.parse_args(["--grid-capacity", "7"]))
    assert cfg.grid_capacity == 7 and cfg.grid3_capacity is None

    cfg = config_from_args(p.parse_args(["--grid-rebin-mode", "axes"]))
    assert cfg.grid_rebin_mode == "axes"

    # --dt must set the timestep, not prefix-match into --dtype (a real
    # failure: the r3 LJ 20.97M check-gate run died parsing dtype="1e-4").
    cfg = config_from_args(p.parse_args(["--force-law", "lj", "--dt", "1e-4"]))
    assert cfg.dt == 1e-4 and cfg.dtype == "float32"


def test_cli_help_lists_every_registered_engine():
    """Help text derives from the registry; this pins it so engine additions
    can't drift the docs again (regressed in rounds 1 AND 2)."""
    from ppsim_tpu.engines import engine_names

    p = build_parser()
    by_flag = {a.option_strings[0]: a.help for a in p._actions if a.option_strings}
    for name in engine_names():
        assert name in by_flag["--engine"], f"{name} missing from --engine help"
    for name in engine_names(3):
        assert name in by_flag["--ndim"], f"{name} missing from --ndim help"


def test_cli_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "state.npz")
    rc = main(["-n", "200", "-s", "7", "--steps", "20", "--checkpoint-out", ck])
    assert rc == 0
    rc = main(["-n", "200", "--steps", "20", "--resume", ck])
    assert rc == 0


def test_cli_engine_selection(tmp_path):
    rc = main(["-n", "200", "-s", "7", "--steps", "10", "--engine", "oracle"])
    assert rc == 0


def test_cli_rejects_unknown_engine():
    with pytest.raises(ValueError):
        main(["-n", "100", "--steps", "5", "--engine", "nope"])


def test_cli_float64_runs_real_f64(tmp_path):
    """--dtype float64 must enable x64 and emit f64 frames — with no
    truncation warning (r3 verdict: the flag was a silent no-op). Runs in a
    subprocess: jax_enable_x64 is process-global."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "traj64.txt")
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "") + os.pathsep + repo
    r = subprocess.run(
        [sys.executable, "-m", "ppsim_tpu", "-n", "300", "-s", "42",
         "--dtype", "float64", "--engine", "binned", "--steps", "30",
         # 8 matches the suite's inherited XLA host-device-count env, so
         # the subprocess's forced CPU backend initializes cleanly
         "--savefreq", "6", "-o", out, "--check", "--cpu-mesh", "8"],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "PASS" in r.stdout
    assert "truncated" not in r.stderr.lower()
    # The saved text format is dtype-agnostic; the frames' provenance is
    # checked in-process by test_native.py's f64 parity test. Here the
    # gate is: real run, checker PASS, no truncation diagnostics.


def test_timed_run_chunked_saved_matches_monolithic(grid_test_config):
    """A chunked SAVED run (unsaved segment programs + host-side frame
    extraction between them) must be bit-identical to the monolithic saved
    program — same frames, same final state — including when chunk_steps is
    NOT aligned with the save or rebin cadence (segments carry the phase,
    so no alignment constraint exists on the saved path; in-program frame
    capture's temporaries add to the step program's peak memory, which is
    why this path exists)."""
    from ppsim_tpu.engines import get_engine
    from ppsim_tpu.harness import timed_run_repeats
    from ppsim_tpu.initlib import init_particles

    cfg = grid_test_config  # rebin_every=4
    state = init_particles(cfg, seed=42)
    savefreq = 2
    mono, _ = timed_run_repeats(get_engine("grid", cfg), state, 16, savefreq,
                                repeats=1)
    for chunk in (8, 6, 3):  # aligned, cadence-misaligned, non-divisor
        chunked, _ = timed_run_repeats(get_engine("grid", cfg), state, 16,
                                       savefreq, repeats=1, chunk_steps=chunk)
        # Exact equality on frames relies on the optimization_barrier at
        # the monolithic program's capture points: without it XLA fuses a
        # recompute of the position chain into the frame consumer, putting
        # in-program frames 1 ulp off the carried state the segment driver
        # reads (a real failure seen when this path landed).
        np.testing.assert_array_equal(mono.frames, chunked.frames)
        np.testing.assert_array_equal(np.asarray(mono.state.pos),
                                      np.asarray(chunked.state.pos))


def test_saved_segment_schedule_invariants():
    """Pure-function contract of the saved-chunk schedule: covers nsteps,
    captures land exactly after global steps 1, 1+savefreq, ... (the
    reference cadence), every segment respects max_seg."""
    from ppsim_tpu.engines.base import Engine

    for nsteps, savefreq, max_seg in [(1000, 100, 200), (1000, 100, 64),
                                      (16, 2, 3), (80, 10, 24), (7, 10, 100),
                                      (1000, 7, 1000)]:
        segs = Engine.saved_segment_schedule(nsteps, savefreq, max_seg)
        assert sum(ln for ln, _ in segs) == nsteps
        assert all(1 <= ln <= max_seg for ln, _ in segs)
        done, captures = 0, []
        for ln, cap in segs:
            done += ln
            if cap:
                captures.append(done)
        expected = [s for s in range(1, nsteps + 1, savefreq)]
        assert captures == expected, (nsteps, savefreq, max_seg, captures)


def test_readme_lists_every_registered_engine():
    """README's engine table must track the registry (docs drifted when
    engines were added in rounds 1 AND 2; help text is already pinned by
    test_cli_help_lists_every_registered_engine — this pins the README)."""
    import os

    from ppsim_tpu.engines import engine_names

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "README.md")) as f:
        readme = f.read()
    for name in engine_names():
        assert f"`{name}`" in readme, f"{name} missing from README"


def test_timed_run_escalation_retry(monkeypatch):
    """The CLI timing path re-runs after a drop-detected capacity
    escalation (Engine.run's retry does not cover timed_run)."""
    from ppsim_tpu import harness

    attempts = []

    class Eng:
        def maybe_escalate_after_drop(self, result):
            return result == "dropped"

    def fake_repeats(engine, state, nsteps, savefreq, repeats=1,
                     chunk_steps=None):
        attempts.append(nsteps)
        return ("dropped" if len(attempts) == 1 else "clean"), [1.5]

    monkeypatch.setattr(harness, "timed_run_repeats", fake_repeats)
    result, seconds = harness.timed_run(Eng(), None, 10, 0)
    assert result == "clean" and seconds == 1.5
    assert attempts == [10, 10]
