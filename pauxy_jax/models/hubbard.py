"""Hubbard model Hamiltonian (1D / 2D square lattice).

Batched counterpart of ``pauxy/systems/hubbard.py:12-165``. The lattice
one-body matrix is built host-side with vectorized numpy (the reference uses
an O(M^2) python double loop, ``pauxy/systems/hubbard_holstein.py:214-268``)
and shipped to device as part of a frozen pytree.

Site ordering: i = ix + nx*iy (``hubbard.py:278-301`` decode_basis).
Twist: boundary-wrap hops pick up a phase exp(i pi k.e) (``kinetic``,
``hubbard_holstein.py:237-259``).
"""

from __future__ import annotations

import numpy as np
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config


@struct.dataclass
class Hubbard:
    """Hubbard Hamiltonian container (pytree).

    Auxiliary-field count for the continuous HS transformation is one field
    per site (``pauxy/systems/hubbard.py:97``: nfields = nbasis).
    """

    T: np.ndarray          # [2, M, M] hopping matrix per spin
    h1e_mod: np.ndarray    # [2, M, M] H1 - U/2 (Motta17 eq. 17 reordering)
    eks: np.ndarray        # [M] single-particle band energies
    U: float = struct.field(pytree_node=False)
    t: float = struct.field(pytree_node=False)
    nx: int = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)
    nup: int = struct.field(pytree_node=False)
    ndown: int = struct.field(pytree_node=False)
    symmetric: bool = struct.field(pytree_node=False)

    name: str = struct.field(pytree_node=False, default="Hubbard")

    @property
    def nbasis(self) -> int:
        return self.nx * self.ny

    @property
    def nfields(self) -> int:
        return self.nbasis

    @property
    def nelec(self) -> tuple[int, int]:
        return (self.nup, self.ndown)

    @property
    def ecore(self) -> float:
        return 0.0


def _lattice_coords(nx: int, ny: int) -> np.ndarray:
    """[M, 2] cartesian coordinates, i = ix + nx*iy."""
    i = np.arange(nx * ny)
    return np.stack([i % nx, i // nx], axis=1)


def kinetic_matrix(
    t: float,
    nx: int,
    ny: int,
    ktwist=None,
    xpbc: bool = True,
    ypbc: bool = True,
) -> np.ndarray:
    """Nearest-neighbour hopping matrix with periodic/twisted boundaries.

    Equivalent to ``pauxy/systems/hubbard_holstein.py:214-268`` but built from
    vectorized displacement tables. Returns [M, M]; complex iff a twist is
    given. For nx==2 (or ny==2) the wrap bond coincides with the direct bond
    and both contributions add, matching the reference's ``+=``.
    """
    m = nx * ny
    coords = _lattice_coords(nx, ny)
    # Displacement of j relative to i, for upper triangle (j > i) only.
    d = np.abs(coords[None, :, :] - coords[:, None, :])     # [M, M, 2]
    upper = np.triu(np.ones((m, m), dtype=bool), k=1)

    if ktwist is not None:
        ktwist = np.asarray(ktwist, dtype=np.float64)
        phase_x = np.exp(1j * np.pi * ktwist[0])
        phase_y = np.exp(1j * np.pi * ktwist[1]) if ny > 1 else 1.0
        tmat = np.zeros((m, m), dtype=np.complex128)
    else:
        phase_x = phase_y = 1.0
        tmat = np.zeros((m, m), dtype=np.float64)

    # Direct nearest neighbours: |dx| + |dy| == 1.
    direct = (d.sum(axis=2) == 1) & upper
    tmat[direct] += -t

    # Boundary wraps (only meaningful when nx > 1 / ny > 1).
    if xpbc and nx > 1:
        wrap_x = (d[:, :, 0] == nx - 1) & (d[:, :, 1] == 0) & upper
        tmat[wrap_x] += -t * phase_x
    if ypbc and ny > 1:
        wrap_y = (d[:, :, 0] == 0) & (d[:, :, 1] == ny - 1) & upper
        tmat[wrap_y] += -t * phase_y

    return tmat + tmat.conj().T


def pinned_kinetic(t: float, nx: int, ny: int) -> np.ndarray:
    """Hopping matrix with staggered pinning fields on the ix = 0 column.

    Counterpart of ``pauxy/systems/hubbard.py:227-276`` (kinetic_pinning_alt,
    Qin16): open x / periodic y boundaries, diagonal fields
    +/- 0.1 t (-1)^{iy} with opposite sign for the two spins.
    Returns [2, M, M] (spin-dependent).
    """
    m = nx * ny
    base = kinetic_matrix(t, nx, ny, ktwist=None, xpbc=False, ypbc=True)
    coords = _lattice_coords(nx, ny)
    h = 0.1 * t
    field = np.where(coords[:, 0] == 0, (-1.0) ** coords[:, 1] * h, 0.0)
    return np.stack([base + np.diag(field), base - np.diag(field)])


def band_energies(t: float, nx: int, ny: int) -> np.ndarray:
    """Single-particle energies e(k) = -2t (cos kx + cos ky), FFT k-ordering.

    Reference: ``pauxy/systems/hubbard.py:327-385`` (kpoints / ek).
    """
    kx = 2.0 * np.pi * np.arange(nx) / nx
    if ny == 1:
        return -2.0 * t * np.cos(kx)
    ky = 2.0 * np.pi * np.arange(ny) / ny
    # kpoints enumerated as (n, m) for n in range(nx) for m in range(ny).
    return (-2.0 * t * (np.cos(kx)[:, None] + np.cos(ky)[None, :])).reshape(-1)


def make_hubbard(
    nup: int,
    ndown: int,
    U: float,
    nx: int,
    ny: int = 1,
    t: float = 1.0,
    ktwist=None,
    xpbc: bool = True,
    ypbc: bool = True,
    symmetric: bool = False,
    pinning_fields: bool = False,
    precision=None,
) -> Hubbard:
    """Build a Hubbard system container.

    Mirrors the options of ``pauxy/systems/hubbard.py:46-105`` incl. the
    pinning-field lattice (``hubbard.py:82-88``).
    """
    prec = config.get_precision(precision)
    m = nx * ny
    if pinning_fields:
        h1 = pinned_kinetic(t, nx, ny)
        dtype = prec.real
        h1 = h1.astype(dtype)
    else:
        tmat = kinetic_matrix(t, nx, ny, ktwist=ktwist, xpbc=xpbc, ypbc=ypbc)
        dtype = prec.cplx if np.iscomplexobj(tmat) else prec.real
        h1 = np.stack([tmat, tmat]).astype(dtype)
    if symmetric:
        h1e_mod = h1
    else:
        v0 = 0.5 * U * np.eye(m)
        h1e_mod = (h1 - v0[None]).astype(dtype)
    return Hubbard(
        T=h1,
        h1e_mod=h1e_mod,
        eks=band_energies(t, nx, ny).astype(prec.real),
        U=float(U),
        t=float(t),
        nx=int(nx),
        ny=int(ny),
        nup=int(nup),
        ndown=int(ndown),
        symmetric=bool(symmetric),
    )


def fcidump_header(nel: int, norb: int, spin: int) -> str:
    """&FCI namelist header (``pauxy/utils/io.py:32-43``)."""
    orbsym = ",".join(["1"] * norb)
    return (
        "&FCI\n"
        f"NORB={int(norb)},\n"
        f"NELEC={int(nel)},\n"
        f"MS2={int(spin)},\n"
        "UHF=.FALSE.,\n"
        f"ORBSYM={orbsym},\n"
        "&END\n"
    )


def fcidump(ham: Hubbard, to_string: bool = False):
    """FCIDUMP of the Hubbard integrals in the site basis.

    Counterpart of ``pauxy/systems/hubbard.py:106-148``: on-site U as
    (ii|ii), hoppings as one-body integrals, core energy 0. Complex
    hoppings (twisted boundaries) use the "(re, im)" format.
    """
    t = np.asarray(ham.T)
    m = ham.nbasis
    cplx = np.iscomplexobj(t) and np.abs(t.imag).max() > 1e-12
    out = fcidump_header(ham.nup + ham.ndown, m, ham.nup - ham.ndown)
    if cplx:
        fmt = "({: 10.8e}, {: 10.8e}) {:>3d} {:>3d} {:>3d} {:>3d}\n"
        for i in range(1, m + 1):
            out += fmt.format(ham.U, 0.0, i, i, i, i)
        for i in range(m):
            for j in range(i + 1, m):
                v = t[0][i, j]
                if abs(v) > 1e-8:
                    out += fmt.format(v.real, v.imag, i + 1, j + 1, 0, 0)
        out += fmt.format(0.0, 0.0, 0, 0, 0, 0)
    else:
        fmt = "{: 10.8e} {:>3d} {:>3d} {:>3d} {:>3d}\n"
        for i in range(1, m + 1):
            out += fmt.format(ham.U, i, i, i, i)
        for i in range(m):
            for j in range(i + 1, m):
                v = t[0][i, j].real
                if abs(v) > 1e-8:
                    out += fmt.format(v, i + 1, j + 1, 0, 0)
        out += fmt.format(0.0, 0, 0, 0, 0)
    if to_string:
        return out
    print(out)
    return None
