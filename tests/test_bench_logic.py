"""Device gates and set-up of the measurement entry points (bench.py,
chip_smoke.py) and the compile-cache helper — none of them may time or
report anything without a GPU. Import by path: the repo root is not
necessarily on sys.path under pytest."""

import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_spec = importlib.util.spec_from_file_location("bench_headline",
                                               ROOT / "bench.py")
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


def test_bench_refuses_a_non_gpu_backend(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main(["--quick"])
    assert "NVIDIA GPU" in str(exc.value)
    assert capsys.readouterr().out == ""  # no JSON line


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On a CPU backend chip_smoke.py exits non-zero and never prints the
    final ``ok`` line — in the checkout, and as a lone copy without the
    package."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_compile_cache_location(monkeypatch, tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing and
    reports that directory; without it, the cache is <checkout>/.jax_cache
    — a fixed path, never a temp, pid or time one."""
    from ppsim_tpu.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
            assert enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = enable_compile_cache()
            assert got == str(ROOT / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            assert enable_compile_cache() == got  # stable across calls
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_checkout_cache_dir_is_gitignored():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_bench_reads_card_name_and_power_limit(monkeypatch):
    """bench.py's JSON names the card and its power limit from nvidia-smi,
    and records None (not a guess) where nvidia-smi is unavailable."""
    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00\n"

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: Done())
    assert bench.gpu_name_and_power_limit() == ("NVIDIA H100 80GB HBM3",
                                                700.0)

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert bench.gpu_name_and_power_limit() == (None, None)
    json.dumps(bench.gpu_name_and_power_limit())


def test_chip_smoke_four_phase_on_cpu_mesh():
    """chip_smoke.py's four-device phase at a tiny size on the CPU mesh
    (kernel interpreted): every pid once, monitors clean, positions within
    the stated bounds of the one-device kernel run."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.run_phase_four(600, 8, jax.devices()[:4], interpret=True)
