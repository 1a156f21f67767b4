"""Device mesh + walker-axis sharding.

The reference parallelizes over MPI ranks: walkers split per rank
(``pauxy/qmc/afqmc.py:167-176``), Allgather/Reduce collectives for population
control and estimators (``walkers/handler.py:230``, ``estimators/
mixed.py:261``), point-to-point walker exchange for branching.

Here: ONE program over global arrays. The walker axis is sharded over a 1-D
``jax.sharding.Mesh``; the jitted block program is compiled SPMD and XLA
inserts the collectives (psum-like reductions for the estimator sums,
all-to-all gathers for the comb permutation) between the devices.
Multi-host uses the same code path with a larger mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

WALKER_AXIS = "walker"
CHOL_AXIS = "chol"

def walker_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices, axis name 'walker'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (WALKER_AXIS,))


def walker_chol_mesh(n_chol: int, devices=None) -> Mesh:
    """2-D mesh [walker, chol] for HBM-bound Generic runs.

    The Cholesky tensor L[M, M, X] (and its half-rotations) is the memory
    hot spot of ab-initio AFQMC; the reference replicates it per node via
    MPI shared windows (``pauxy/utils/mpi.py:13-35``, ``systems/
    utils.py:86-123``). Here the X axis is sharded over the 'chol' mesh
    axis and XLA completes the force-bias/VHS/energy contractions with
    psum collectives (SURVEY.md section 2.11).
    """
    if devices is None:
        devices = jax.devices()
    nd = len(devices)
    assert nd % n_chol == 0, f"{nd} devices not divisible by n_chol={n_chol}"
    return Mesh(
        np.asarray(devices).reshape(nd // n_chol, n_chol),
        (WALKER_AXIS, CHOL_AXIS),
    )


def shard_generic(ham, trial, prop, mesh: Mesh):
    """Place a Generic Hamiltonian + trial + propagator on a [walker, chol]
    mesh with every Cholesky-indexed tensor sharded over its X axis.

    chol [M, M, X] -> P(None, None, 'chol'); rchol [(D,) X, n, M] ->
    P((None,) 'chol'); mf_shift [X] -> P('chol'); everything else
    replicated.
    """
    repl = NamedSharding(mesh, P())

    def x_sharding(ndim: int, x_axis: int) -> NamedSharding:
        spec = [None] * ndim
        spec[x_axis] = CHOL_AXIS
        return NamedSharding(mesh, P(*spec))

    def place_repl(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(jax.numpy.asarray(x), repl), tree
        )

    def place_x(arr, x_axis):
        arr = jax.numpy.asarray(arr)
        return jax.device_put(arr, x_sharding(arr.ndim, x_axis))

    ham = place_repl(ham)
    if getattr(ham, "chol", None) is not None:
        ham = ham.replace(chol=place_x(ham.chol, -1))
    trial = place_repl(trial)
    if getattr(trial, "rchola", None) is not None:
        x_axis = 0 if trial.rchola.ndim == 3 else 1   # MSD: [D, X, n, M]
        trial = trial.replace(
            rchola=place_x(trial.rchola, x_axis),
            rcholb=place_x(trial.rcholb, x_axis),
        )
    prop = place_repl(prop)
    inner = prop.inner
    updates = {}
    if getattr(inner, "chol", None) is not None:
        updates["chol"] = place_x(inner.chol, -1)
    if getattr(inner, "mf_shift", None) is not None:
        updates["mf_shift"] = place_x(inner.mf_shift, 0)
    if updates:
        prop = prop.replace(inner=inner.replace(**updates))
    return ham, trial, prop


def shard_walkers(state, mesh: Mesh):
    """Place a WalkerState with the walker axis sharded over the mesh.

    Per-walker arrays get P('walker', ...); scalars (total_weight) are
    replicated. Equivalent to the reference's per-rank walker split at
    ``afqmc.py:167-176`` — but the global arrays stay addressable.
    """
    nshard = dict(zip(mesh.axis_names, mesh.devices.shape))[WALKER_AXIS]
    leaves = [x for x in jax.tree_util.tree_leaves(state)
              if getattr(x, "ndim", 0) >= 1]
    if leaves and leaves[0].shape[0] % nshard != 0:
        raise ValueError(
            f"walker count {leaves[0].shape[0]} is not divisible by the "
            f"walker mesh size {nshard}; pick a multiple (the reference "
            "splits walkers evenly per rank the same way, afqmc.py:167-176)"
        )
    sharded = NamedSharding(mesh, P(WALKER_AXIS))
    replicated = NamedSharding(mesh, P())

    def place(x):
        x = jax.numpy.asarray(x)
        if x.ndim >= 1:
            return jax.device_put(x, sharded)
        return jax.device_put(x, replicated)

    return jax.tree_util.tree_map(place, state)


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (Hamiltonian/trial/propagator tables) on the mesh."""
    replicated = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(jax.numpy.asarray(x), replicated), tree
    )
