"""Test configuration.

Tests run on CPU in double precision for parity with the reference numbers
(the reference is numpy/complex128). Multi-device tests use 8 virtual CPU
devices (the XLA host-platform device-count trick replaces the reference's
mpiexec-based CI, cf. SURVEY.md section 4).
"""

import os

# Must be set before the CPU backend is instantiated.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Long single-process suites accumulate hundreds of LLVM-JIT'd
# executables and have produced sporadic segfaults inside XLA:CPU
# backend_compile_and_load late in the run. Dropping live executables
# between modules bounds that growth; the on-disk compilation cache makes
# the re-compiles cheap across modules and across suite runs.
from pauxy_jax import config as _config  # noqa: E402

_config.enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_cache_growth():
    yield
    jax.clear_caches()

# Make the read-only reference importable as a serial oracle: it hard-imports
# mpi4py in a few modules; tools/oracle provides a serial stand-in.
import sys  # noqa: E402

try:
    import mpi4py  # noqa: F401
except ImportError:
    _shim = os.path.join(os.path.dirname(__file__), "..", "tools", "oracle")
    sys.path.append(os.path.abspath(_shim))
