"""hibayes_tpu.runtime: the one place that picks the device path, and the
compile-cache rule; chip_smoke.py refuses to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from hibayes_tpu import runtime

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("backend,kernels", [("gpu", True), ("cpu", False)])
def test_kernel_path_per_platform(monkeypatch, backend, kernels):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert runtime.platform() == backend
    assert runtime.use_kernels() is kernels


def test_gpu_never_interprets(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(runtime, "_TEST_INTERPRET", True)
    assert runtime.interpret() is False


def test_cpu_kernels_only_under_a_test(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(RuntimeError, match="only a test"):
        runtime.interpret()
    monkeypatch.setattr(runtime, "_TEST_INTERPRET", True)
    assert runtime.use_kernels() and runtime.interpret()


@pytest.mark.parametrize("backend", ["tpu", "rocm", "METAL"])
def test_other_platforms_raise(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        runtime.use_kernels()


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("env", [None, ""])
def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config, env):
    if env is None:
        monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(runtime.CACHE_ENV, env)
    path = runtime.configure_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_follows_env(monkeypatch, tmp_path, cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    assert runtime.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the code sets nothing else
    assert jax.config.jax_compilation_cache_dir is None


def test_import_sets_the_cache_and_tests_keep_none():
    """Importing the package points the cache at its directory on every
    platform; the test suite switches the cache off, here and in the
    processes it starts."""
    assert jax.config.jax_compilation_cache_dir == runtime.compile_cache_dir()
    assert jax.config.jax_enable_compilation_cache is False
    r = subprocess.run(
        [sys.executable, "-c", "import jax, hibayes_tpu; "
         "print(jax.config.jax_enable_compilation_cache, "
         "jax.config.jax_compilation_cache_dir)"],
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", runtime.compile_cache_dir()]


def test_chip_smoke_refuses_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO), XLA_FLAGS="")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
