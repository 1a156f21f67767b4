"""Sparse plane-wave density operators for the UEG.

The reference keeps the momentum-transfer operators rho_q as scipy sparse
matrices (``pauxy/systems/ueg.py:336-428``) — one nonzero per column:
rho_q[idx(k+q), k] = sqrt(pi / (vol q^2)). Round 1 stored them DENSE as
[nq, M, M], which is O(nq M^2) HBM and blows out a single chip at the basis
sizes the reference handles on CPU (nq grows ~8x faster than M with ecut).

This module is the sparse replacement. The key structural fact: for any
matrix position (a, b) there is AT MOST ONE q with k_a - k_b = q (the q grid
is a set of distinct vectors), so the whole operator family inverts into a
single [M, M] integer map Q[a, b] = index(k_a - k_b) and

  sum_q c1_q rho_q + c2_q rho_q^T  =  c1[Q] * F  +  (c2[Q] * F)^T ,

with F[a, b] = sqrt(pi/(vol q^2)) masked where k_a - k_b is off-grid. VHS
assembly is therefore one batched GATHER from the per-q coefficients — no
scatter-add, no [nq, M, M]
tensor, O(M^2) metadata. Expectations <rho_q>/<rho_q^T> stay masked gathers
over the [nq, M] ``kpq`` index map. Both reproduce the reference's sparsity
exactly; nothing is truncated.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct


@struct.dataclass
class SparseRho:
    """Gather metadata for {rho_q} (static shapes, built host-side)."""

    qmap: jax.Array      # [M, M] int32: index of q = k_a - k_b (0 if off-grid)
    fac: jax.Array       # [M, M] real: sqrt(pi/(vol q^2)) at qmap, 0 off-grid
    kpq_idx: jax.Array   # [nq, M] int32 idx(k_i + q) (0 where invalid)
    kpq_fac: jax.Array   # [nq, M] real factor * mask
    qfac: jax.Array      # [nq] real sqrt(pi/(vol q^2))
    nbasis: int = struct.field(pytree_node=False)
    nq: int = struct.field(pytree_node=False)


def make_sparse_rho(ham, real_dtype) -> SparseRho:
    """Build the gather metadata from a UEG Hamiltonian's gather maps.

    ``ham`` needs ``basis`` [M, 3], ``qvecs`` [nq, 3], ``kpq_idx/kpq_mask``
    [nq, M], ``vqvec`` [nq] (= 4 pi/q^2) and ``vol``; factor =
    sqrt(pi/(vol q^2)) = sqrt(vqvec / (4 vol)) (``ueg.py:336-358``).
    """
    basis = np.asarray(ham.basis)
    qvecs = np.asarray(ham.qvecs)
    kpq_idx = np.asarray(ham.kpq_idx)
    kpq_mask = np.asarray(ham.kpq_mask)
    nq, m = kpq_idx.shape
    factor = np.sqrt(np.asarray(ham.vqvec) / (4.0 * ham.vol))

    # Invert the operator family: Q[a, b] = q-index of k_a - k_b.
    qlut = {tuple(v): i for i, v in enumerate(qvecs)}
    qmap = np.zeros((m, m), dtype=np.int32)
    fac = np.zeros((m, m), dtype=real_dtype)
    diff = basis[:, None, :] - basis[None, :, :]          # [M, M, 3]
    for a in range(m):
        for b in range(m):
            iq = qlut.get(tuple(diff[a, b]))
            if iq is not None:
                qmap[a, b] = iq
                fac[a, b] = factor[iq]
    # Consistency: (a, b) = (kpq_idx[q, b], b) must round-trip to q.
    qi, ii = np.nonzero(kpq_mask)
    assert (qmap[kpq_idx[qi, ii], ii] == qi).all()

    return SparseRho(
        qmap=jnp.asarray(qmap),
        fac=jnp.asarray(fac),
        kpq_idx=jnp.asarray(kpq_idx.astype(np.int32)),
        kpq_fac=jnp.asarray((factor[:, None] * kpq_mask).astype(real_dtype)),
        qfac=jnp.asarray(factor.astype(real_dtype)),
        nbasis=int(m),
        nq=int(nq),
    )


def rho_expectations(sp: SparseRho, g: jax.Array):
    """(<rho_q>, <rho_q^T>) of g [w, M, M] as masked gathers, each [w, nq].

    t1[w,q] = sum_m g[w, idx(k_m + q), m] * fac,
    t2[w,q] = sum_p g[w, p, idx(k_p + q)] * fac.
    """
    cols = jnp.arange(sp.nbasis)[None, :]
    t1 = jnp.sum(g[:, sp.kpq_idx, cols] * sp.kpq_fac[None], axis=-1)
    t2 = jnp.sum(g[:, cols, sp.kpq_idx] * sp.kpq_fac[None], axis=-1)
    return t1, t2


def assemble_vhs(sp: SparseRho, c1: jax.Array, c2: jax.Array) -> jax.Array:
    """sum_q (c1[w,q] rho_q + c2[w,q] rho_q^T) as a dense [w, M, M] array.

    One gather of the per-q coefficients through the [M, M] q-map per term.
    The result is dense because the VHS exponential consumes it as a matmul
    operand; only the *operator basis* storage is sparse.
    """
    t1 = c1[:, sp.qmap] * sp.fac[None]
    t2 = c2[:, sp.qmap] * sp.fac[None]
    return t1 + t2.swapaxes(-1, -2)
