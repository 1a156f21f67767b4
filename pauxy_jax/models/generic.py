"""Generic ab-initio Hamiltonian from Cholesky-factorized ERIs.

Batched counterpart of ``pauxy/systems/generic.py:22-210``. The
two-electron integrals enter as Cholesky vectors L with
(ik|jl) = sum_x L[i,k,x] L[j,l,x]; one auxiliary field per Cholesky vector
(``generic.py:154-159``: hs_pot = chol_vecs, nfields = nchol).

Integrals are loaded host-side (QMCPACK HDF5 / FCIDUMP / direct arrays) and
stored dense as [M, M, X] — the counterpart of the reference's node-shared
replication (``pauxy/systems/utils.py:86-123``) is plain HBM replication per
chip (sharding over X is the scale-out path).
"""

from __future__ import annotations

import numpy as np
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config


@struct.dataclass
class Generic:
    """Ab-initio Hamiltonian container (pytree)."""

    H1: np.ndarray         # [2, M, M] one-electron integrals
    h1e_mod: np.ndarray    # [2, M, M] H1 - 0.5 sum_x L[i,k,x] L[j,k,x]
    chol: np.ndarray       # [M, M, X] Cholesky vectors L[i,k,x]
    ecore: float = struct.field(pytree_node=False)
    nup: int = struct.field(pytree_node=False)
    ndown: int = struct.field(pytree_node=False)
    name: str = struct.field(pytree_node=False, default="Generic")
    # Local-energy variant flags (``pauxy/systems/generic.py:74-123``):
    # exact_eri uses the half-rotated 4-index ERIs; stochastic_ri estimates
    # the exchange with nsamples Rademacher probes (optionally with the
    # trial as a control variate); pno truncates the half-rotated pair ERIs
    # by SVD at thresh_pno.
    exact_eri: bool = struct.field(pytree_node=False, default=False)
    stochastic_ri: bool = struct.field(pytree_node=False, default=False)
    nsamples: int = struct.field(pytree_node=False, default=0)
    control_variate: bool = struct.field(pytree_node=False, default=False)
    pno: bool = struct.field(pytree_node=False, default=False)
    thresh_pno: float = struct.field(pytree_node=False, default=0.0)

    @property
    def nbasis(self) -> int:
        return self.H1.shape[-1]

    @property
    def nchol(self) -> int:
        return self.chol.shape[-1]

    @property
    def nfields(self) -> int:
        return self.chol.shape[-1]

    @property
    def nelec(self) -> tuple[int, int]:
        return (self.nup, self.ndown)


def construct_h1e_mod(h1e: np.ndarray, chol: np.ndarray) -> np.ndarray:
    """h1e_mod = H1 - v0 with v0_ij = 0.5 sum_{k x} L[i,k,x] L[j,k,x].

    Eqn (17) of Motta17; reference ``generic.py:202-210``.
    """
    v0 = 0.5 * np.einsum("ikx,jkx->ij", chol, chol, optimize=True)
    return np.stack([h1e[0] - v0, h1e[1] - v0])


def make_generic(
    nelec: tuple[int, int],
    h1e: np.ndarray,
    chol: np.ndarray,
    ecore: float = 0.0,
    precision=None,
    exact_eri: bool = False,
    stochastic_ri: bool = False,
    nsamples: int = 0,
    control_variate: bool = False,
    pno: bool = False,
    thresh_pno: float = 0.0,
) -> Generic:
    """Build a Generic system from arrays.

    ``h1e``: [M, M] (spin-restricted) or [2, M, M].
    ``chol``: [M, M, X] or flat [M*M, X] (the reference's layout).
    """
    prec = config.get_precision(precision)
    h1e = np.asarray(h1e)
    if h1e.ndim == 2:
        h1e = np.stack([h1e, h1e])
    m = h1e.shape[-1]
    chol = np.asarray(chol)
    if chol.ndim == 2:
        chol = chol.reshape(m, m, -1)
    dtype = prec.cplx if np.iscomplexobj(h1e) or np.iscomplexobj(chol) else prec.real
    h1e = h1e.astype(dtype)
    chol = chol.astype(dtype)
    if stochastic_ri and nsamples <= 0:
        raise ValueError("stochastic_ri needs nsamples > 0")
    if pno and not thresh_pno:
        raise ValueError("pno needs thresh_pno > 0")
    return Generic(
        H1=h1e,
        h1e_mod=construct_h1e_mod(h1e, chol).astype(dtype),
        chol=chol,
        ecore=float(ecore),
        nup=int(nelec[0]),
        ndown=int(nelec[1]),
        exact_eri=bool(exact_eri),
        stochastic_ri=bool(stochastic_ri),
        nsamples=int(nsamples),
        control_variate=bool(control_variate),
        pno=bool(pno),
        thresh_pno=float(thresh_pno or 0.0),
    )


def from_qmcpack_file(filename: str, nelec=None, precision=None) -> Generic:
    """Load a Generic system from a QMCPACK-format HDF5 integral file."""
    from pauxy_jax.utils import qmcpack

    h1e, chol, ecore, nelec_file = qmcpack.read_hamiltonian(filename)
    if nelec is None:
        nelec = nelec_file
    if nelec is None:
        raise ValueError("electron count not in file; pass nelec=")
    return make_generic(nelec, h1e, chol, ecore, precision=precision)
