"""Device <-> host transfer helpers for pytrees with complex leaves.

``to_host`` / ``to_device`` move a pytree between host and device, with
complex leaves carried as separate real and imaginary parts and recombined
on the far side. ``device_scalar`` and ``device_zeros`` build complex
device values under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _fetch(x):
    if isinstance(x, jax.Array) and jnp.iscomplexobj(x):
        ri = np.asarray(jnp.stack([jnp.real(x), jnp.imag(x)]))
        return ri[0] + 1j * ri[1]
    if isinstance(x, jax.Array):
        return np.asarray(x)
    return x


def to_host(tree):
    """device_get a pytree, splitting complex leaves into real transfers."""
    return jax.tree_util.tree_map(_fetch, tree)


@jax.jit
def _combine(re, im):
    return re + 1j * im


def _upload(x):
    if isinstance(x, jax.Array):
        return x
    x = np.asarray(x)
    if np.iscomplexobj(x):
        re = jnp.asarray(np.ascontiguousarray(x.real))
        im = jnp.asarray(np.ascontiguousarray(x.imag))
        return _combine(re, im)
    return jnp.asarray(x)


def to_device(tree):
    """jnp.asarray a pytree, splitting complex leaves into real transfers."""
    return jax.tree_util.tree_map(_upload, tree)


import functools


@functools.partial(jax.jit, static_argnames=("dtype",))
def _fill_scalar(re, im, dtype):
    return (re + 1j * im).astype(dtype)


def device_scalar(value, dtype):
    """Complex scalar upload: ships the real/imag parts as real scalars at
    the target dtype's real precision (so float64 targets keep full
    precision) and combines under jit."""
    value = complex(value)
    rdtype = np.zeros((), dtype).real.dtype
    return _fill_scalar(
        jnp.asarray(value.real, rdtype),
        jnp.asarray(value.imag, rdtype),
        dtype,
    )


@functools.partial(jax.jit, static_argnames=("shape", "dtype"))
def device_zeros(shape, dtype):
    """Zeros of a static shape and dtype, filled by a compiled program."""
    return jnp.zeros(shape, dtype)


class StaticArray:
    """Content-hashed numpy wrapper for STATIC (non-pytree) array fields of
    pytree dataclasses (utils/pytree.py). jit caches compare static metadata with ``==`` and
    ``hash``; a bare ndarray raises ("truth value of an array ...") the
    moment a second, different instance of the struct reaches the same jit.
    Supports ``np.asarray(x)`` and ``.shape`` for host consumers."""

    __slots__ = ("arr", "_hash")

    def __init__(self, arr):
        self.arr = np.ascontiguousarray(arr)
        self.arr.setflags(write=False)
        self._hash = hash((self.arr.shape, self.arr.dtype.str,
                           self.arr.tobytes()))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        if isinstance(other, StaticArray):
            other = other.arr
        return (
            isinstance(other, np.ndarray)
            and self.arr.shape == other.shape
            and bool(np.array_equal(self.arr, other))
        )

    def __array__(self, dtype=None, copy=None):
        return self.arr if dtype is None else self.arr.astype(dtype)

    def __getitem__(self, ix):
        return self.arr[ix]

    @property
    def shape(self):
        return self.arr.shape

    def __len__(self):
        return len(self.arr)


class HostArray:
    """Identity-hashable wrapper letting host-only numpy data ride a pytree
    dataclass as a STATIC (non-pytree) field — it is never uploaded to
    device (jit commits every pytree leaf of its arguments)."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other
