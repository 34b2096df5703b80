"""Test harness config: run everything on a virtual 8-device CPU mesh.

Mirrors the test strategy gap analysis in SURVEY.md section 4: the reference
ships no test suite, so we build the pyramid ourselves, and multi-device
sharding logic must be testable without accelerator hardware via
``--xla_force_host_platform_device_count``.
"""

import os

# Must be set before the XLA backend initializes (jax may already be imported
# by the environment, but the backend is lazy).
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Enable x64 so exactness tests (blocked Gibbs vs. sequential oracle) can run
# at f64 tolerance; production code derives dtype from its inputs and stays f32.
jax.config.update("jax_enable_x64", True)
# tests compile small programs afresh; nothing is kept in the on-disk cache,
# in this process or in the ones the tests start (JAX reads the variable)
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the Pallas-Triton kernels in interpret mode on the CPU (the only
    way a kernel runs off the GPU)."""
    from hibayes_tpu import runtime

    monkeypatch.setattr(runtime, "_TEST_INTERPRET", True)


@pytest.fixture
def gpu():
    """Skip unless JAX has a GPU (decided here, never at import)."""
    from hibayes_tpu import runtime

    if runtime.platform() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` there")


@pytest.fixture(autouse=True, scope="module")
def _drop_compile_caches_per_module():
    """Release compiled executables between modules.

    A single pytest process accumulates hundreds of XLA:CPU compilations
    (incl. large 8-device shard_map programs); past ~85% of the suite the
    next backend_compile segfaulted the process (observed in both round-2
    and round-3 full runs, at different tests — a cumulative compile
    resource issue, not one bad test).  Dropping jit/lowering caches after
    each module lets the C++ executables be GC'd and keeps the peak low.
    """
    yield
    jax.clear_caches()
