"""Device path: the one place that looks at the JAX backend.

* GPU: the sweeps run their per-block sequential draws in the compiled
  Pallas-Triton kernels (`ops/blockgibbs.py`); interpret mode is never on.
* CPU: fits use the plain XLA scan.  A Pallas kernel runs here, in
  interpret mode, only when a test asks for it (`tests/conftest.py`'s
  `interpret_kernels` fixture sets `_TEST_INTERPRET`).
* Any other backend is an error.

It also owns the persistent compile cache: `JAX_COMPILATION_CACHE_DIR` when
set, else `.jax_cache/` at the root of the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# set only by the test suite: run the Pallas kernels in interpret mode on CPU
_TEST_INTERPRET = False

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def platform() -> str:
    """The JAX backend, 'gpu' or 'cpu'; anything else raises."""
    p = jax.default_backend()
    if p not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX backend {p!r}: hibayes_tpu runs on an NVIDIA GPU "
            "(CUDA) or, for tests, on the CPU")
    return p


def use_kernels() -> bool:
    """Whether the sweeps run their draws in the Pallas kernels
    (`GibbsSpec.use_pallas`): always on the GPU, on the CPU only under a
    test that asks for interpret mode."""
    return platform() == "gpu" or _TEST_INTERPRET


def interpret() -> bool:
    """Interpret mode for a Pallas call about to be traced."""
    if platform() == "gpu":
        return False
    if not _TEST_INTERPRET:
        raise RuntimeError(
            "the Pallas kernels are compiled for the GPU; on the CPU only a "
            "test may run them (in interpret mode)")
    return True


def compile_cache_dir() -> str:
    """Where compiled executables persist between processes."""
    return os.environ.get(CACHE_ENV) or str(DEFAULT_CACHE_DIR)


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at `compile_cache_dir()`.  With
    the environment variable set JAX already reads it, so nothing else is
    set in code."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
