"""FFT-grid plane-wave UEG (PW_FFT).

Batched counterpart of ``pauxy/systems/pw_fft.py:26-260``: the same
physics as models/ueg.py but with the basis laid out on a 3D FFT mesh so the
two-body propagator, force bias and local energy are convolutions — batched
``jnp.fft.fftn`` calls instead of dense [nq, M, M] density matrices. This is
the scalable path: O(Ng log Ng) per orbital instead of O(nq M^2).

Grid conventions: k-space cubes are stored in FFT frequency order
(index = n mod N per axis), so circular convolution indices line up with
momentum sums directly and no fftshift rolls are needed. Both the basis
sphere (2 ecut ball, mesh (2 nmax+1)^3) and the momentum transfers
(4 ecut ball, qmesh (4 nmax+1)^3) are embedded in the LARGER qmesh cube;
aliased convolution components land at |n| >= nmax+1, outside the kept
sphere, so the circular FFT convolution equals the reference's zero-padded
linear one (propagation/pw.py:120-155) on every retained component.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.utils.transfer import StaticArray
from pauxy_jax.models.ueg import madelung


@struct.dataclass
class PWFFT:
    """Plane-wave UEG on an FFT mesh."""

    sp_eigv: np.ndarray    # [M] single-particle energies (diag one-body)
    h1e_mod: np.ndarray    # [M] diagonal modified one-body term
    vqvec: np.ndarray      # [nq] 4 pi / q^2 (0 at q = 0)
    gmap: np.ndarray       # [M] basis -> flattened qmesh cube (fft order)
    qmap: np.ndarray       # [nq] qvecs -> flattened qmesh cube (fft order)
    basis: np.ndarray = struct.field(pytree_node=False)   # [M, 3] int
    qvecs: np.ndarray = struct.field(pytree_node=False)   # [nq, 3] int
    qmesh: tuple = struct.field(pytree_node=False)        # (N, N, N)
    rs: float = struct.field(pytree_node=False)
    ecut: float = struct.field(pytree_node=False)
    vol: float = struct.field(pytree_node=False)
    kfac: float = struct.field(pytree_node=False)
    ecore: float = struct.field(pytree_node=False)
    nup: int = struct.field(pytree_node=False)
    ndown: int = struct.field(pytree_node=False)
    nmax: int = struct.field(pytree_node=False)
    name: str = struct.field(pytree_node=False, default="PW_FFT")

    @property
    def nbasis(self) -> int:
        return self.basis.shape[0]

    @property
    def nq(self) -> int:
        return self.qvecs.shape[0]

    @property
    def nfields(self) -> int:
        return 2 * self.nq

    @property
    def nelec(self):
        return (self.nup, self.ndown)

    @property
    def ne(self) -> int:
        return self.nup + self.ndown

    @property
    def T(self):
        t = np.diag(self.sp_eigv)
        return np.stack([t, t])

    @property
    def kf(self) -> float:
        zeta = 1 if self.ndown == 0 else 0
        return (3 * (zeta + 1) * math.pi ** 2 * self.ne / self.vol) ** (1 / 3)

    @property
    def ef(self) -> float:
        return 0.5 * self.kf ** 2


def _sphere(ecut: float, nmax: int):
    """All integer k with |k|^2/2 <= ecut, grid (itertools.product) order
    matching the reference enumeration (pw_fft.py:198-217)."""
    rng = np.arange(-nmax, nmax + 1)
    kall = np.array(list(itertools.product(rng, rng, rng)), dtype=np.int64)
    keep = 0.5 * np.sum(kall * kall, axis=1) <= ecut
    return kall[keep]


def _fft_index(vecs: np.ndarray, n: int) -> np.ndarray:
    """Flattened index of integer k-vectors in an n^3 cube, fft order."""
    w = np.mod(vecs, n)
    return (w[:, 0] * n + w[:, 1]) * n + w[:, 2]


def make_pw_fft(
    nup: int,
    ndown: int,
    rs: float,
    ecut: float,
    ktwist=None,
    precision=None,
) -> PWFFT:
    """Build the PW_FFT system (``systems/pw_fft.py:58-178``)."""
    prec = config.get_precision(precision)
    ne = nup + ndown
    L = rs * (4.0 * ne * np.pi / 3.0) ** (1.0 / 3.0)
    vol = L ** 3
    kfac = 2 * np.pi / L
    tw = np.zeros(3) if ktwist is None else np.asarray(ktwist, float)

    nmax = int(math.ceil(math.sqrt(2 * ecut)))
    basis = _sphere(ecut, nmax)
    ks = basis + tw[None, :]
    sp_eigv = 0.5 * kfac ** 2 * np.sum(ks * ks, axis=1)

    qvecs = _sphere(4.0 * ecut, 2 * nmax)
    qsq = kfac ** 2 * np.sum(qvecs * qvecs, axis=1).astype(float)
    vqvec = np.where(qsq > 1e-10, 4.0 * np.pi / np.where(qsq > 0, qsq, 1.0),
                     0.0)

    ngrid = 4 * nmax + 1
    qmesh = (ngrid, ngrid, ngrid)
    gmap = _fft_index(basis, ngrid)
    qmap = _fft_index(qvecs, ngrid)

    # Diagonal exchange shift (ueg_kernels.pyx mod_one_body): subtract
    # (1/2V) sum_{j != i} v(k_i - k_j) from each diagonal element.
    diff = basis[:, None, :] - basis[None, :, :]
    dsq = kfac ** 2 * np.sum(diff * diff, axis=-1).astype(float)
    vdiff = np.where(dsq > 1e-10, 4.0 * np.pi / np.where(dsq > 0, dsq, 1.0),
                     0.0)
    h1e_mod = sp_eigv - vdiff.sum(axis=1) / (2.0 * vol)

    return PWFFT(
        sp_eigv=sp_eigv.astype(prec.real),
        h1e_mod=h1e_mod.astype(prec.real),
        vqvec=vqvec.astype(prec.real),
        gmap=gmap,
        qmap=qmap,
        basis=StaticArray(basis),
        qvecs=StaticArray(qvecs),
        qmesh=qmesh,
        rs=float(rs),
        ecut=float(ecut),
        vol=float(vol),
        kfac=float(kfac),
        ecore=float(0.5 * ne * madelung(rs, ne)),
        nup=int(nup),
        ndown=int(ndown),
        nmax=int(nmax),
    )
