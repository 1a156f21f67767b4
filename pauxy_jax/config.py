"""Precision configuration.

The reference (pauxy) is float64/complex128 throughout. Here precision is a
*parameter of the simulation* rather than a global:

* ``precision="single"``  -> float32 / complex64 (accelerator default)
* ``precision="double"``  -> float64 / complex128 (requires jax x64; used by
  the CPU test-suite for parity with the reference numbers)

AFQMC tolerates single precision well at zero temperature because walkers are
QR-re-orthogonalised every ``nstblz`` steps and all overlap bookkeeping here
is done in log space. The finite-T stabilized products default to double.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype bundle threaded through systems/trials/propagators."""

    real: jnp.dtype
    cplx: jnp.dtype

    @property
    def name(self) -> str:
        return "double" if self.real == jnp.float64 else "single"


SINGLE = Precision(real=jnp.dtype(jnp.float32), cplx=jnp.dtype(jnp.complex64))
DOUBLE = Precision(real=jnp.dtype(jnp.float64), cplx=jnp.dtype(jnp.complex128))


# Matmul-precision ladder: tier name -> jax_default_matmul_precision value.
# On an H100 (jax 0.9) 'highest' runs full-f32 GEMMs (2.6e-6 relative on a
# 4096^3 f32 GEMM) and 'tensorfloat32' TF32 tensor-core GEMMs (2.9e-4);
# JAX's own default is TF32 too. The bf16 dot-algorithm presets give wrong
# complex64 products there, so they are no tier (PERF.md).
MATMUL_TIERS = {
    "float32": "highest",
    "tensorfloat32": "tensorfloat32",
}


def set_matmul_precision(policy: str | None = None) -> str:
    """Set jax's default matmul precision for f32/c64 operands.

    The drivers default to 'float32' (full f32); 'tensorfloat32' is the
    opt-in faster tier. ``policy`` None reads ``PAUXY_MATMUL`` (default
    'float32'). No-op on CPU, whose f32 matmuls are always full f32.
    Returns the tier in force.
    """
    if policy is None:
        import os

        policy = os.environ.get("PAUXY_MATMUL", "float32")
    if policy not in MATMUL_TIERS:
        raise ValueError(
            f"unknown matmul-precision tier {policy!r}; "
            f"expected one of {sorted(MATMUL_TIERS)}"
        )
    if jax.default_backend() == "cpu":
        return "float32"
    jax.config.update("jax_default_matmul_precision", MATMUL_TIERS[policy])
    return policy


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself, and nothing else is set here). Otherwise the cache lives at the
    fixed path ``<checkout>/.jax_cache``, which ``.gitignore`` lists.
    """
    import os

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def get_precision(name: str | Precision | None = None) -> Precision:
    """Resolve a precision spec.

    ``None`` picks double when jax x64 is enabled (tests / CPU), else single
    (accelerator runs).
    """
    if isinstance(name, Precision):
        return name
    if name is None:
        return DOUBLE if jax.config.jax_enable_x64 else SINGLE
    name = name.lower()
    if name in ("single", "f32", "float32", "complex64"):
        return SINGLE
    if name in ("double", "f64", "float64", "complex128"):
        if not jax.config.jax_enable_x64:
            raise ValueError(
                "double precision requested but jax x64 is disabled; "
                "set JAX_ENABLE_X64=1 or jax.config.update('jax_enable_x64', True)"
            )
        return DOUBLE
    raise ValueError(f"unknown precision: {name!r}")
