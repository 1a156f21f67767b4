"""Hubbard-Holstein model: electrons + local (Holstein) phonons.

Batched counterpart of ``pauxy/systems/hubbard_holstein.py:12-212``
(system), ``pauxy/trial_wavefunction/harmonic_oscillator.py:7-50``
(phonon trial wavefunction helpers, here as batched jnp functions) and
``pauxy/trial_wavefunction/coherent_state.py`` (variational coherent-state
trial — the reference itself optimizes with jax.grad; here it's an
alternating electron-SCF / analytic-shift minimization with an optional
optax polish).

H = -t sum c^dag c + U sum n_up n_dn + sum_i [ p_i^2/2m + m w0^2 X_i^2 / 2 ]
    - g sqrt(2 m w0) sum_i rho_i X_i
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.models.hubbard import band_energies, kinetic_matrix


@struct.dataclass
class HubbardHolstein:
    T: np.ndarray
    h1e_mod: np.ndarray
    eks: np.ndarray
    U: float = struct.field(pytree_node=False)
    t: float = struct.field(pytree_node=False)
    g: float = struct.field(pytree_node=False)
    w0: float = struct.field(pytree_node=False)
    m: float = struct.field(pytree_node=False)
    lmbda: float = struct.field(pytree_node=False)
    nx: int = struct.field(pytree_node=False)
    ny: int = struct.field(pytree_node=False)
    nup: int = struct.field(pytree_node=False)
    ndown: int = struct.field(pytree_node=False)
    symmetric: bool = struct.field(pytree_node=False, default=False)
    name: str = struct.field(pytree_node=False, default="HubbardHolstein")

    @property
    def nbasis(self) -> int:
        return self.nx * self.ny

    @property
    def nfields(self) -> int:
        return self.nbasis

    @property
    def nelec(self):
        return (self.nup, self.ndown)

    @property
    def ecore(self) -> float:
        return 0.0

    @property
    def gsq2mw(self) -> float:
        """g sqrt(2 m w0): the electron-phonon coupling prefactor."""
        return self.g * np.sqrt(2.0 * self.m * self.w0)


def make_hubbard_holstein(
    nup: int,
    ndown: int,
    U: float,
    nx: int,
    ny: int = 1,
    t: float = 1.0,
    w0: float = 1.0,
    lmbda: float = 1.0,
    g: float | None = None,
    m: float | None = None,
    xpbc: bool = True,
    ypbc: bool = True,
    precision=None,
) -> HubbardHolstein:
    """g defaults to sqrt(d 2 lambda t w0) with d the dimensionality
    (``hubbard_holstein.py:92-97``); m defaults to 1/w0."""
    prec = config.get_precision(precision)
    if m is None:
        m = 1.0 / w0
    if g is None:
        d = 1 if ny == 1 else 2
        g = np.sqrt(d * 2.0 * lmbda * t * w0)
    mm = nx * ny
    tmat = kinetic_matrix(t, nx, ny, ktwist=None, xpbc=xpbc, ypbc=ypbc)
    h1 = np.stack([tmat, tmat]).astype(prec.real)
    v0 = 0.5 * U * np.eye(mm)
    return HubbardHolstein(
        T=h1,
        h1e_mod=np.stack([tmat - v0, tmat - v0]).astype(prec.real),
        eks=band_energies(t, nx, ny).astype(prec.real),
        U=float(U), t=float(t), g=float(g), w0=float(w0), m=float(m),
        lmbda=float(lmbda), nx=int(nx), ny=int(ny),
        nup=int(nup), ndown=int(ndown),
    )


# ----------------------------------------------------------------------------
# Harmonic-oscillator phonon trial helpers (batched; reference
# harmonic_oscillator.py:7-50 works on one walker at a time)
# ----------------------------------------------------------------------------

def ho_log_value(x, m, w0, shift):
    """log of prod_i exp(-m w0 (x - shift)^2 / 2) (unnormalized)."""
    d = x - shift
    return -0.5 * m * w0 * jnp.sum(d * d, axis=-1)


def ho_gradient(x, m, w0, shift):
    return -m * w0 * (x - shift)


def ho_laplacian(x, m, w0, shift):
    d = x - shift
    return (m * w0) ** 2 * d * d - m * w0


def ho_local_energy(x, m, w0, shift):
    """Bosonic local energy with the ZPE convention of the reference
    (harmonic_oscillator.py:34-43: -w0 M/2 subtracted)."""
    nsites = x.shape[-1]
    ke = -0.5 * jnp.sum(ho_laplacian(x, m, w0, shift), axis=-1) / m
    pot = 0.5 * m * w0 * w0 * jnp.sum(x * x, axis=-1)
    return ke + pot - 0.5 * w0 * nsites


# ----------------------------------------------------------------------------
# Coherent-state trial
# ----------------------------------------------------------------------------

def coherent_state_trial(
    ham: HubbardHolstein,
    max_scf: int = 200,
    tol: float = 1e-8,
    precision=None,
):
    """Self-consistent coherent-state trial.

    Alternating minimization of the variational energy (the fixed point of
    the reference's jax/ADAM optimization, ``coherent_state.py:601-720``):
      given shift X: H_eff = T - g sqrt(2 m w0) diag(X) (+ U mean field),
      given density n: X_i = g sqrt(2 m w0) n_i / (m w0^2).
    """
    prec = config.get_precision(precision)
    mlat = ham.nbasis
    t0 = np.asarray(ham.T[0])
    cpl = ham.gsq2mw
    shift = np.zeros(mlat)
    niup = np.full(mlat, ham.nup / mlat)
    nidown = np.full(mlat, ham.ndown / mlat)
    e_old = np.inf
    for _ in range(max_scf):
        ha = t0 + ham.U * np.diag(nidown) - cpl * np.diag(shift)
        hb = t0 + ham.U * np.diag(niup) - cpl * np.diag(shift)
        ea, va = np.linalg.eigh(ha)
        eb, vb = np.linalg.eigh(hb)
        psia = va[:, : ham.nup]
        psib = vb[:, : ham.ndown]
        niup = np.einsum("mi,mi->m", psia, psia.conj()).real
        nidown = np.einsum("mi,mi->m", psib, psib.conj()).real
        rho = niup + nidown
        shift = cpl * rho / (ham.m * ham.w0 ** 2)
        ke = np.sum(t0 * (psia @ psia.conj().T + psib @ psib.conj().T).T)
        pe = ham.U * np.dot(niup, nidown)
        eph = 0.5 * ham.m * ham.w0 ** 2 * np.dot(shift, shift) - cpl * np.dot(
            rho, shift
        )
        e_new = ke + pe + eph
        if abs(e_new - e_old) < tol:
            break
        e_old = e_new

    from pauxy_jax.models.trial import SingleDetTrial
    from pauxy_jax.utils.transfer import HostArray, to_device

    dtype = prec.cplx
    psia_c = psia.astype(dtype)
    psib_c = psib.astype(dtype)
    from pauxy_jax.models.trial import trial_density_matrix

    g_mat = trial_density_matrix(psia_c, psib_c)
    psia_d = to_device(psia_c)
    psib_d = to_device(psib_c)
    trial = SingleDetTrial(
        psia=psia_d,
        psib=psib_d,
        inita=psia_d,
        initb=psib_d,
        shift=jnp.asarray(shift.astype(prec.real)),
        G_host=HostArray(g_mat),
        etrial=float(np.real(e_new)),
        name="coherent_state",
    )
    return trial


def _lf_params(ham: HubbardHolstein):
    """Standard Lang-Firsov dressing gamma and the effective Hubbard U
    (``systems/hubbard_holstein.py:107-110``)."""
    gamma = ham.g * np.sqrt(2.0 / (ham.m * ham.w0 ** 3))
    ueff = (
        ham.U
        + gamma ** 2 * ham.m * ham.w0 ** 2
        - 2.0 * ham.g * gamma * np.sqrt(2.0 * ham.m * ham.w0)
    )
    return gamma, ueff


def lang_firsov_energy(ham: HubbardHolstein, psia, psib, gamma):
    """Variational energy of the LF-transformed Hamiltonian at zero shift
    (``trial_wavefunction/lang_firsov.py:47-126`` objective_function):

      E = sum_i (gamma_i^2 m w0^2/2 - g gamma_i sqrt(2 m w0)) n_i
        + sum_i (U + gamma_i^2 m w0^2 - 2 g gamma_i sqrt(2 m w0)) n_ia n_ib
        + sum_ij e^{-(a_i^2+a_j^2)/2} T_ij G_ij,  a = gamma sqrt(m w0/2).
    """
    ga = (psia @ np.linalg.inv(psia.conj().T @ psia) @ psia.conj().T).T
    if psib.shape[1] > 0:
        gb = (psib @ np.linalg.inv(psib.conj().T @ psib) @ psib.conj().T).T
    else:
        gb = np.zeros_like(ga)
    nia, nib = np.diag(ga).real, np.diag(gb).real
    ni = nia + nib
    sq2mw = np.sqrt(2.0 * ham.m * ham.w0)
    gamma = np.asarray(gamma) * np.ones(ham.nbasis)
    eeph = np.sum(
        (gamma ** 2 * ham.m * ham.w0 ** 2 / 2.0 - ham.g * gamma * sq2mw) * ni
    )
    eee = np.sum(
        (ham.U + gamma ** 2 * ham.m * ham.w0 ** 2
         - 2.0 * ham.g * gamma * sq2mw) * nia * nib
    )
    alpha = gamma * np.sqrt(ham.m * ham.w0 / 2.0)
    const = np.exp(-0.5 * alpha ** 2)
    cmat = np.outer(const, const)
    t = np.asarray(ham.T)
    ekin = np.sum(cmat * t[0] * ga + cmat * t[1] * gb).real
    return float(eeph + eee + ekin)


def lang_firsov_trial(
    ham: HubbardHolstein,
    relax_gamma: bool = False,
    restricted: bool = False,
    nrestart: int = 5,
    precision=None,
):
    """Variationally optimised Lang-Firsov trial.

    Counterpart of ``trial_wavefunction/lang_firsov.py:128-320``: orbital
    rotations C_s = C0_s exp(theta_s) (theta antisymmetric from the
    occupied-virtual block) minimising the LF objective; gamma fixed to the
    standard polaron value g sqrt(2/(m w0^3)) unless relax_gamma. The
    phonon shift is zero in the LF frame (``lang_firsov.py:284``).
    """
    import scipy.linalg
    import scipy.optimize

    prec = config.get_precision(precision)
    m = ham.nbasis
    na, nb = ham.nup, ham.ndown
    nva, nvb = m - na, m - nb
    t = np.asarray(ham.T)
    _, c0a = np.linalg.eigh(t[0])
    _, c0b = np.linalg.eigh(t[1])
    gamma0, _ = _lf_params(ham)

    def unpack(x):
        daia = x[: nva * na].reshape(nva, na)
        daib = x[nva * na : nva * na + nvb * nb].reshape(nvb, nb)
        if restricted:
            daib = daia
        gamma = (
            x[nva * na + nvb * nb :] if relax_gamma else gamma0 * np.ones(m)
        )
        return daia, daib, gamma

    def orbitals(daia, daib):
        tha = np.zeros((m, m))
        tha[na:, :na] = daia
        tha[:na, na:] = -daia.T
        thb = np.zeros((m, m))
        thb[nb:, :nb] = daib
        thb[:nb, nb:] = -daib.T
        ca = c0a @ scipy.linalg.expm(tha)
        cb = c0b @ scipy.linalg.expm(thb)
        return ca[:, :na], cb[:, :nb]

    def objective(x):
        daia, daib, gamma = unpack(x)
        psia, psib = orbitals(daia, daib)
        return lang_firsov_energy(ham, psia, psib, gamma)

    nparam = nva * na + nvb * nb + (m if relax_gamma else 0)
    rng = np.random.default_rng(7)
    best_e, best_x = np.inf, np.zeros(nparam)
    x = np.zeros(nparam)
    if relax_gamma:
        x[nva * na + nvb * nb :] = gamma0
    for it in range(nrestart):
        res = scipy.optimize.minimize(objective, x, method="L-BFGS-B")
        if res.fun < best_e - 1e-6:
            best_e, best_x = res.fun, res.x.copy()
        else:
            break
        x = best_x + 0.01 * rng.standard_normal(nparam)
        if relax_gamma:
            x[nva * na + nvb * nb :] = np.abs(x[nva * na + nvb * nb :])
    daia, daib, gamma = unpack(best_x)
    psia, psib = orbitals(daia, daib)

    from pauxy_jax.models.trial import SingleDetTrial, trial_density_matrix
    from pauxy_jax.utils.transfer import HostArray, to_device

    psia_c = psia.astype(prec.cplx)
    psib_c = psib.astype(prec.cplx)
    g_mat = trial_density_matrix(psia_c, psib_c)
    psia_d = to_device(psia_c)
    psib_d = to_device(psib_c)
    trial = SingleDetTrial(
        psia=psia_d,
        psib=psib_d,
        inita=psia_d,
        initb=psib_d,
        shift=jnp.zeros((m,), prec.real),
        G_host=HostArray(g_mat),
        etrial=float(best_e),
        name="lang_firsov",
    )
    return trial, np.asarray(gamma)
