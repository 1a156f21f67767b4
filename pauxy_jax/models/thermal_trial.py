"""Finite-temperature trial density matrices.

Batched counterpart of ``pauxy/trial_density_matrices/onebody.py:15-114``
(OneBody), ``chem_pot.py:7-67`` (bisection chemical-potential search) and
``mean_field.py:14-94`` (thermal HF). All setup is host-side numpy/scipy;
what reaches the device is the slice propagator B_T (including e^{dt mu})
and its inverse, plus precomputed within-bin left partial products.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.linalg
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.estimators.thermal import (
    one_rdm_stable_host,
    particle_number_host,
)


@struct.dataclass
class OneBodyTrial:
    """rho_T = prod exp(-dt (H1 - mu N)) trial density matrix (pytree)."""

    dmat: Any              # [2, M, M] B_T for one slice (incl. mu factor)
    dmat_inv: Any          # [2, M, M]
    # left_table[c] = B_T^{stack_size - 1 - c}: the remaining trial part of
    # the active bin after c+1 propagator applications (stack.py:299-325's
    # deterministic `left` factors, precomputed since they are
    # walker-independent).
    left_table: Any        # [stack_size, 2, M, M]
    bin_full: Any          # [2, M, M] = B_T^{stack_size} (fresh bin value)
    mu: float = struct.field(pytree_node=False)
    beta: float = struct.field(pytree_node=False)
    dt: float = struct.field(pytree_node=False)
    num_slices: int = struct.field(pytree_node=False)
    stack_size: int = struct.field(pytree_node=False)
    nav: float = struct.field(pytree_node=False)
    P_host: Any = struct.field(pytree_node=False, default=None)  # HostArray
    G_host: Any = struct.field(pytree_node=False, default=None)
    name: str = struct.field(pytree_node=False, default="one_body")

    @property
    def nbins(self) -> int:
        return self.num_slices // self.stack_size

    @property
    def nbasis(self) -> int:
        return self.dmat.shape[-1]


def find_chemical_potential(
    rho_dtau: np.ndarray,
    dtau: float,
    num_bins: int,
    target: float,
    deps: float = 1e-6,
    max_it: int = 1000,
    sign: int = 1,
) -> float:
    """Bracket + bisect mu so that <N>(mu) = target (chem_pot.py:7-61)."""

    def nav(mu):
        rho_mu = rho_dtau * np.exp(sign * dtau * mu)
        return particle_number_host(one_rdm_stable_host(rho_mu, num_bins))

    mu1, mu2 = -1.0, 1.0
    d1, d2 = nav(mu1) - target, nav(mu2) - target
    while np.sign(d1) * np.sign(d2) > 0:
        mu1 -= 2
        mu2 += 2
        d1, d2 = nav(mu1) - target, nav(mu2) - target
        if mu2 > 200:
            raise RuntimeError("chemical potential bracket not found")
    for _ in range(max_it):
        mu = 0.5 * (mu1 + mu2)
        d = nav(mu) - target
        if abs(d) < deps:
            return mu
        if d * d1 > 0:
            mu1, d1 = mu, d
        else:
            mu2, d2 = mu, d
    raise RuntimeError("chemical potential bisection did not converge")


def make_one_body_trial(
    ham,
    beta: float,
    dt: float,
    mu: float | None = None,
    nav: float | None = None,
    stack_size: int | None = None,
    deps: float = 1e-6,
    precision=None,
    alt_convention: bool = False,
) -> OneBodyTrial:
    """Build the OneBody trial (onebody.py:17-114)."""
    prec = config.get_precision(precision)
    from pauxy_jax.utils.transfer import HostArray, to_device

    h1 = np.asarray(getattr(ham, "H1", None) if hasattr(ham, "H1") else ham.T)
    dmat = np.stack(
        [scipy.linalg.expm(-dt * h1[0]), scipy.linalg.expm(-dt * h1[1])]
    )
    num_slices = int(round(beta / dt))
    if stack_size is None:
        # cond(BT)^stack <= 1e3 heuristic (onebody.py:56-71).
        cond = np.linalg.cond(dmat[0])
        stack_size = max(1, min(num_slices, int(3.0 / np.log10(cond))))
    while num_slices % stack_size != 0:
        stack_size -= 1
    num_bins = num_slices // stack_size
    dtau = stack_size * dt
    sign = -1 if alt_convention else 1

    rho = np.stack(
        [scipy.linalg.expm(-dtau * h1[0]), scipy.linalg.expm(-dtau * h1[1])]
    )
    if mu is None:
        target = nav if nav is not None else (ham.nup + ham.ndown)
        mu = find_chemical_potential(
            rho, dtau, num_bins, target, deps=deps, sign=sign
        )

    rho_mu = rho * np.exp(sign * dtau * mu)
    p = one_rdm_stable_host(rho_mu, num_bins)
    nav_actual = particle_number_host(p)
    g = np.stack([np.eye(ham.nbasis) - p[0].T, np.eye(ham.nbasis) - p[1].T])

    dmat_mu = dmat * np.exp(sign * dt * mu)
    dmat_inv = np.stack(
        [scipy.linalg.inv(dmat_mu[0]), scipy.linalg.inv(dmat_mu[1])]
    )
    # Precompute B_T powers for the within-bin left factors.
    powers = [np.stack([np.eye(ham.nbasis)] * 2)]
    for _ in range(stack_size):
        powers.append(
            np.stack([dmat_mu[0] @ powers[-1][0], dmat_mu[1] @ powers[-1][1]])
        )
    left_table = np.stack(
        [powers[stack_size - 1 - c] for c in range(stack_size)]
    )
    cdtype = prec.cplx
    return OneBodyTrial(
        dmat=to_device(dmat_mu.astype(cdtype)),
        dmat_inv=to_device(dmat_inv.astype(cdtype)),
        left_table=to_device(left_table.astype(cdtype)),
        bin_full=to_device(powers[stack_size].astype(cdtype)),
        mu=float(mu),
        beta=float(beta),
        dt=float(dt),
        num_slices=num_slices,
        stack_size=int(stack_size),
        nav=float(np.real(nav_actual)),
        P_host=HostArray(p),
        G_host=HostArray(g),
    )


# ----------------------------------------------------------------------------
# Fock matrices and thermal Hartree-Fock (MeanField) trial
# ----------------------------------------------------------------------------

def fock_matrix(ham, p: np.ndarray) -> np.ndarray:
    """F per spin from the 1-RDM (``pauxy/estimators/fock.py:5-28`` dispatch;
    Hubbard: ``estimators/hubbard.py:208-214``; Generic: J/K from Cholesky
    vectors, ``estimators/generic.py:458-466`` analogue)."""
    name = ham.name
    if name in ("Hubbard", "HubbardHolstein"):
        t = np.asarray(ham.T)
        niu = np.diag(np.diagonal(p[0]))
        nid = np.diag(np.diagonal(p[1]))
        return t + ham.U * np.stack([nid, niu])
    if name == "Generic":
        chol = np.asarray(ham.chol)
        h1 = np.asarray(ham.H1)
        rho = p[0] + p[1]
        xv = np.einsum("pqx,pq->x", chol, rho, optimize=True)
        j = np.einsum("pqx,x->pq", chol, xv, optimize=True)
        out = []
        for s in (0, 1):
            k = np.einsum("prx,rs,sqx->pq", chol, p[s], chol, optimize=True)
            out.append(h1[s] + j - k)
        return np.stack(out)
    if name == "UEG":
        # Diagonal (plane-wave) Fock: kinetic + Hartree (q=0 cancels) -
        # exchange via the gather maps is more involved; use the one-body
        # part (adequate as a THF seed for the UEG, cf. fock_ueg usage).
        return np.asarray(ham.H1)
    raise NotImplementedError(name)


def make_mean_field_trial(
    ham,
    beta: float,
    dt: float,
    nav: float | None = None,
    mu: float | None = None,
    find_mu: bool = True,
    stack_size: int | None = None,
    alpha: float = 0.75,
    max_macro_it: int = 100,
    max_scf_it: int = 100,
    deps: float = 1e-6,
    precision=None,
    verbose: bool = False,
) -> OneBodyTrial:
    """Thermal Hartree-Fock trial density matrix.

    Counterpart of ``pauxy/trial_density_matrices/mean_field.py:14-94``:
    macro-iterate the chemical potential, with an inner SCF on the Fock
    matrix (density mixing alpha) at fixed mu; the converged HMF defines the
    slice propagator. With ``verbose``, logs the grand potential
    Omega = E - mu N - S/beta per macro iteration using the mean-field
    entropy (``mean_field.py:83-88`` + ``thermal.py:198-210``).
    """
    num_slices = int(round(beta / dt))
    target = nav if nav is not None else (ham.nup + ham.ndown)
    m = ham.nbasis

    # Seed from the one-body trial (also fixes the stack binning).
    seed = make_one_body_trial(ham, beta, dt, mu=mu, nav=nav,
                               stack_size=stack_size, deps=deps,
                               precision=precision)
    stack_size = seed.stack_size
    num_bins = num_slices // stack_size
    dtau = stack_size * dt
    p = np.asarray(seed.P_host.arr)
    mu_old = seed.mu
    # find_mu=False keeps the given chemical potential fixed through the
    # macro iteration (mean_field.py:24,46-52).
    mu_fixed = None if find_mu else (mu if mu is not None else seed.mu)
    hmf = fock_matrix(ham, p)
    for _ in range(max_macro_it):
        # Inner SCF at fixed mu (mean_field.py:64-94).
        p_old = p
        for _ in range(max_scf_it):
            hmf = fock_matrix(ham, p_old)
            rho = np.stack([
                scipy.linalg.expm(-dtau * (hmf[0] - mu_old * np.eye(m))),
                scipy.linalg.expm(-dtau * (hmf[1] - mu_old * np.eye(m))),
            ])
            p_new = (1 - alpha) * one_rdm_stable_host(rho, num_bins) + (
                alpha * p_old
            )
            if np.linalg.norm(p_new - p_old) < deps:
                p_old = p_new
                break
            p_old = p_new
        p = p_old
        rho0 = np.stack([
            scipy.linalg.expm(-dtau * hmf[0]),
            scipy.linalg.expm(-dtau * hmf[1]),
        ])
        if mu_fixed is not None:
            mu = mu_fixed
        else:
            mu = find_chemical_potential(rho0, dtau, num_bins, target,
                                         deps=deps)
        if verbose:
            from pauxy_jax.estimators import local_energy as le
            from pauxy_jax.estimators.thermal import entropy

            n_cur = float(np.real(particle_number_host(p)))
            e_cur = float(np.real(le.local_energy_G_host(
                ham, np.eye(m)[None] - p.transpose(0, 2, 1))[0]))
            s_cur = entropy(beta, mu, hmf)
            omega = e_cur - mu * n_cur - s_cur / beta
            print(f" # THF macro-iteration: mu = {mu:13.8e} "
                  f"Omega = {omega:13.8e}")
        if abs(mu - mu_old) < deps:
            mu_old = mu
            break
        mu_old = mu

    # Slice propagator from the converged HMF (mean_field.py:26-31).
    prec = config.get_precision(precision)
    from pauxy_jax.utils.transfer import HostArray, to_device

    dmat = np.stack([
        scipy.linalg.expm(-dt * (hmf[0] - mu_old * np.eye(m))),
        scipy.linalg.expm(-dt * (hmf[1] - mu_old * np.eye(m))),
    ])
    dmat_inv = np.stack([scipy.linalg.inv(dmat[0]), scipy.linalg.inv(dmat[1])])
    rho_mu = np.stack([
        scipy.linalg.expm(-dtau * (hmf[0] - mu_old * np.eye(m))),
        scipy.linalg.expm(-dtau * (hmf[1] - mu_old * np.eye(m))),
    ])
    p_final = one_rdm_stable_host(rho_mu, num_bins)
    g = np.stack([np.eye(m) - p_final[0].T, np.eye(m) - p_final[1].T])
    powers = [np.stack([np.eye(m)] * 2)]
    for _ in range(stack_size):
        powers.append(np.stack([dmat[0] @ powers[-1][0],
                                dmat[1] @ powers[-1][1]]))
    left_table = np.stack(
        [powers[stack_size - 1 - c] for c in range(stack_size)]
    )
    cdtype = prec.cplx
    return OneBodyTrial(
        dmat=to_device(dmat.astype(cdtype)),
        dmat_inv=to_device(dmat_inv.astype(cdtype)),
        left_table=to_device(left_table.astype(cdtype)),
        bin_full=to_device(powers[stack_size].astype(cdtype)),
        mu=float(mu_old),
        beta=float(beta),
        dt=float(dt),
        num_slices=num_slices,
        stack_size=int(stack_size),
        nav=float(np.real(particle_number_host(p_final))),
        P_host=HostArray(p_final),
        G_host=HostArray(g),
        name="mean_field",
    )
