"""Uniform electron gas (3D, plane waves).

Batched counterpart of ``pauxy/systems/ueg.py:11-605``. The reference
represents the momentum-transfer density operators rho_q as scipy sparse
matrices (``ueg.py:336-428``) and evaluates their Green's-function
contractions in Cython (``ueg_kernels.pyx``). Here:

* rho_q stays SPARSE: the system carries only the integer gather maps
  kpq/pmq ([nq, M] index + mask). Propagator force-bias/VHS contractions
  are masked gathers + a sorted segment-sum scatter (ops/ueg_sparse.py) —
  O(nq M) storage like the reference's scipy matrices, never [nq, M, M].
* The energy kernels use the same maps: the Cython O(nnz) / O(nnz^2) loops
  become masked gathers + reductions, vectorized over walkers (see
  estimators/local_energy.py).

Units/conventions follow the reference exactly: kfac = 2 pi / L, energies in
Hartree, ecut in scaled units, q grid = 4*ecut sphere minus q=0
(``ueg.py:116-122``), Madelung core energy (``ueg.py:266-286``).
"""

from __future__ import annotations

import numpy as np
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.utils.transfer import StaticArray


@struct.dataclass
class UEG:
    """UEG Hamiltonian container (pytree)."""

    H1: np.ndarray         # [2, M, M] diagonal kinetic energy
    h1e_mod: np.ndarray    # [2, M, M] with the exchange-fock diagonal shift
    kpq_idx: np.ndarray    # [nq, M] int32: index of k_i + q (0 if invalid)
    kpq_mask: np.ndarray   # [nq, M] bool
    pmq_idx: np.ndarray    # [nq, M] int32: index of k_i - q
    pmq_mask: np.ndarray   # [nq, M] bool
    vqvec: np.ndarray      # [nq] Coulomb kernel 4 pi / q^2
    basis: np.ndarray = struct.field(pytree_node=False)   # [M, 3] int
    qvecs: np.ndarray = struct.field(pytree_node=False)   # [nq, 3] int
    rs: float = struct.field(pytree_node=False)
    ecut: float = struct.field(pytree_node=False)
    vol: float = struct.field(pytree_node=False)
    kfac: float = struct.field(pytree_node=False)
    ecore: float = struct.field(pytree_node=False)
    nup: int = struct.field(pytree_node=False)
    ndown: int = struct.field(pytree_node=False)
    # FFT-cube embeddings for the pseudo-spectral energy fast path
    # (ueg_kernels.pyx:77-133 exchange_greens_function_fft): basis/q vectors
    # on a (4 nmax + 1)^3 grid in fft frequency order.
    gmap: np.ndarray = None    # [M] int32
    qmap: np.ndarray = None    # [nq] int32
    qmesh: tuple = struct.field(pytree_node=False, default=None)
    name: str = struct.field(pytree_node=False, default="UEG")

    @property
    def ne(self) -> int:
        return self.nup + self.ndown

    @property
    def kf(self) -> float:
        """Fermi wavevector of the infinite system (``ueg.py:84``);
        zeta = 1 when fully polarised (ndown == 0)."""
        import math

        zeta = 1 if self.ndown == 0 else 0
        return (3 * (zeta + 1) * math.pi ** 2 * self.ne / self.vol) ** (1 / 3)

    @property
    def ef(self) -> float:
        """Fermi energy, used for theta = T/T_F reduced units (``ueg.py:86``)."""
        return 0.5 * self.kf ** 2

    @property
    def nbasis(self) -> int:
        return self.H1.shape[-1]

    @property
    def nq(self) -> int:
        return self.vqvec.shape[0]

    @property
    def nchol(self) -> int:
        return self.nq

    @property
    def nfields(self) -> int:
        # x_+ (for iA) and x_- (for iB) per q (ueg.py:122).
        return 2 * self.nq

    @property
    def nelec(self) -> tuple[int, int]:
        return (self.nup, self.ndown)


def plane_wave_basis(ecut: float, ktwist=None):
    """All integer k-vectors with |n|^2/2 <= ecut, sorted by twist-shifted
    kinetic energy (stable sort — matches ``ueg.py:194-239``).

    Returns (eigs_unscaled, nvecs [M,3], nmax). eigs are in units of kfac^2.
    """
    nmax = int(np.ceil(np.sqrt(2 * ecut)))
    grid = np.arange(-nmax, nmax + 1)
    n = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), axis=-1).reshape(-1, 3)
    spe = 0.5 * np.sum(n * n, axis=1)
    keep = spe <= ecut
    n = n[keep]
    ks = np.zeros(3) if ktwist is None else np.asarray(ktwist, dtype=float)
    ek = 0.5 * np.sum((n + ks) ** 2, axis=1)
    # The reference enumerates ni (x) outermost, then nj, nk — meshgrid 'ij'
    # reproduces that enumeration order, so a stable sort matches its
    # tie-breaking exactly.
    order = np.argsort(ek, kind="stable")
    return ek[order], n[order], nmax


def _index_map(basis: np.ndarray, nmax: int):
    """Linear-index lookup table: k-vector -> basis index (ueg.py:241-264)."""
    shifted = 2 * nmax
    lin = (basis[:, 0] + nmax) + shifted * (basis[:, 1] + nmax) + shifted ** 2 * (
        basis[:, 2] + nmax
    )
    lookup = -np.ones(lin.max() + 1, dtype=np.int64)
    lookup[lin] = np.arange(len(basis))
    imax_sq = int(np.dot(basis[-1], basis[-1]))

    def lookup_vec(vecs: np.ndarray):
        """vecs [N,3] -> (idx [N], valid [N])."""
        inside = np.sum(vecs * vecs, axis=1) <= imax_sq
        l = (vecs[:, 0] + nmax) + shifted * (vecs[:, 1] + nmax) + shifted ** 2 * (
            vecs[:, 2] + nmax
        )
        in_table = inside & (l >= 0) & (l < len(lookup))
        idx = np.where(in_table, lookup[np.clip(l, 0, len(lookup) - 1)], -1)
        valid = idx >= 0
        return np.where(valid, idx, 0), valid

    return lookup_vec


def madelung(rs: float, ne: int) -> float:
    """Schoof et al. fit for the Madelung constant (ueg.py:266-286)."""
    c1 = -2.837297
    c2 = (3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
    return c1 * c2 / (ne ** (1.0 / 3.0) * rs)


def make_ueg(
    nup: int,
    ndown: int,
    rs: float,
    ecut: float,
    ktwist=None,
    precision=None,
) -> UEG:
    """Build the UEG system (host-side, vectorized numpy)."""
    prec = config.get_precision(precision)
    ne = nup + ndown
    L = rs * (4.0 * ne * np.pi / 3.0) ** (1.0 / 3.0)
    vol = L ** 3
    kfac = 2 * np.pi / L

    eigs, basis, nmax = plane_wave_basis(ecut, ktwist)
    m = len(basis)
    sp_eigv = kfac ** 2 * eigs
    lookup = _index_map(basis, nmax)

    # Momentum transfers: 4*ecut sphere, q = 0 dropped (ueg.py:116-118).
    _, qvecs, _ = plane_wave_basis(ecut * 4.0, None)
    qvecs = qvecs[1:] if np.all(qvecs[0] == 0) else qvecs[~np.all(qvecs == 0, 1)]
    nq = len(qvecs)
    qsq = kfac ** 2 * np.sum(qvecs * qvecs, axis=1)
    vqvec = 4 * np.pi / qsq

    # Gather maps: for each q, i -> index(k_i + q) and i -> index(k_i - q).
    kpq = basis[None, :, :] + qvecs[:, None, :]           # [nq, M, 3]
    pmq = basis[None, :, :] - qvecs[:, None, :]
    kpq_idx, kpq_mask = lookup(kpq.reshape(-1, 3))
    pmq_idx, pmq_mask = lookup(pmq.reshape(-1, 3))
    kpq_idx = kpq_idx.reshape(nq, m)
    kpq_mask = kpq_mask.reshape(nq, m)
    pmq_idx = pmq_idx.reshape(nq, m)
    pmq_mask = pmq_mask.reshape(nq, m)

    # The scaled density operators rho_q[k+q, k] = sqrt(pi/(vol q^2))
    # (ueg.py:336-428) are NOT materialized: propagators/estimators consume
    # the (kpq_idx, kpq_mask, vqvec) gather maps via ops/ueg_sparse.

    # One-body: T = diag(sp_eigv); h1e_mod subtracts the q-summed Coulomb
    # diagonal 1/(2 vol) sum_{j != i} 4 pi/|k_i - k_j|^2 (ueg.py:288-310).
    t = np.diag(sp_eigv)
    diff = kfac * (basis[:, None, :] - basis[None, :, :])
    dsq = np.sum(diff * diff, axis=-1)
    with np.errstate(divide="ignore"):
        vq_pair = np.where(dsq > 1e-12, 4 * np.pi / np.where(dsq > 0, dsq, 1.0), 0.0)
    fock_diag = np.sum(vq_pair, axis=1) / (2.0 * vol)
    h1e_mod = t - np.diag(fock_diag)

    # FFT-cube maps: the (4 nmax + 1)^3 grid holds every k +/- q without
    # circular aliasing (|k|_inf <= nmax, |q|_inf <= 2 nmax), matching
    # models/pw_fft.py.
    ngrid = 4 * nmax + 1

    def fft_index(vecs):
        w = np.mod(vecs, ngrid)
        return (
            (w[:, 0] * ngrid + w[:, 1]) * ngrid + w[:, 2]
        ).astype(np.int32)

    rdtype = prec.real
    return UEG(
        H1=np.stack([t, t]).astype(rdtype),
        h1e_mod=np.stack([h1e_mod, h1e_mod]).astype(rdtype),
        kpq_idx=kpq_idx.astype(np.int32),
        kpq_mask=kpq_mask,
        pmq_idx=pmq_idx.astype(np.int32),
        pmq_mask=pmq_mask,
        vqvec=vqvec.astype(rdtype),
        basis=StaticArray(basis),
        qvecs=StaticArray(qvecs),
        rs=float(rs),
        ecut=float(ecut),
        vol=float(vol),
        kfac=float(kfac),
        ecore=0.5 * ne * madelung(rs, ne),
        nup=int(nup),
        ndown=int(ndown),
        gmap=fft_index(basis),
        qmap=fft_index(qvecs),
        qmesh=(ngrid, ngrid, ngrid),
    )
