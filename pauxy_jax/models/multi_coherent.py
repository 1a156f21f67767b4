"""Multi-coherent-state trial wavefunctions for the Hubbard-Holstein model.

Batched counterpart of ``pauxy/walkers/multi_coherent.py:11-497`` (the
walker algebra) and the symmetrized / multi-component branches of
``pauxy/trial_wavefunction/coherent_state.py:258-600``. The trial is

  |Psi_T> = sum_p c_p |psi_p> (x) |phi_B(shift_p)>,

a sum of (Slater determinant x coherent phonon state) components. The walker
stays a single determinant phi plus phonon coordinates X (reusing the SoA
``WalkerState``); all per-component quantities are batched einsums over the
[w, P] axes with log-space component weights

  log u_p = log conj(c_p) + logdet S_pa + logdet S_pb + log phi_B,p(X),
  log phi_B,p(X) = -(m w0 / 2) sum_i (X_i - shift_p_i)^2   (order-0 HO).

The reference symmetrizes over ALL nbasis! lattice permutations
(``coherent_state.py:468-472``), tractable only for <= 3 sites; here the
symmetrization subgroup is the nx*ny lattice TRANSLATIONS (the physically
meaningful momentum projection), and arbitrary explicit component stacks are
accepted.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.ops import clinalg


@struct.dataclass
class MultiCoherentTrial:
    """Multi-component electron-phonon trial."""

    psi: Any               # [P, M, na+nb] complex component determinants
    shifts: Any            # [P, M] real component phonon displacements
    coeffs: Any            # [P] complex
    inita: Any             # [M, na]
    initb: Any             # [M, nb]
    shift: Any = None      # [M] leading-component shift (walker X init)
    nup: int = struct.field(pytree_node=False, default=0)
    m: float = struct.field(pytree_node=False, default=1.0)
    w0: float = struct.field(pytree_node=False, default=1.0)
    etrial: float = struct.field(pytree_node=False, default=0.0)
    name: str = struct.field(pytree_node=False, default="multi_coherent")

    @property
    def nperms(self) -> int:
        return self.psi.shape[0]

    @property
    def nbasis(self) -> int:
        return self.psi.shape[1]

    @property
    def ndown(self) -> int:
        return self.psi.shape[2] - self.nup


def boson_log_value(trial: MultiCoherentTrial, x):
    """log phi_B,p(X) [w, P]: order-0 harmonic oscillator product
    (``harmonic_oscillator.py:7-44``), unnormalized like the reference."""
    d = x[:, None, :] - trial.shifts[None, :, :]
    return -0.5 * trial.m * trial.w0 * jnp.sum(d * d, axis=-1)


def component_log_weights(trial: MultiCoherentTrial, phia, phib, x):
    """log u_p [w, P] complex + the per-component spin overlap inverses.

    Returns (logw, sa, sb) with sa [w, P, na, na], sb [w, P, nb, nb]
    (overlap matrices; inverses are taken where needed).
    """
    na = trial.nup
    ta = trial.psi[:, :, :na]
    tb = trial.psi[:, :, na:]
    sa = jnp.einsum("pmi,wmj->wpij", ta.conj(), phia, optimize=True)
    sb = jnp.einsum("pmi,wmj->wpij", tb.conj(), phib, optimize=True)
    logd = clinalg.slogdet(sa) + clinalg.slogdet(sb)      # [w, P] complex
    logb = boson_log_value(trial, x).astype(logd.dtype)
    logw = logd + logb + jnp.log(trial.coeffs.conj())[None, :]
    return logw, sa, sb


def mc_log_overlap(trial: MultiCoherentTrial, phia, phib, x):
    """log <Psi_T|phi, X> = log sum_p u_p (complex logsumexp), [w]."""
    logw, _, _ = component_log_weights(trial, phia, phib, x)
    ref = jnp.max(logw.real, axis=-1, keepdims=True)
    return jnp.log(jnp.sum(jnp.exp(logw - ref), axis=-1)) + ref[:, 0]


def mc_greens_function(trial: MultiCoherentTrial, phia, phib, x):
    """(Gi [w, P, 2, M, M], comp_weights [w, P]) — per-component Green's
    functions G_p = (phi S_p^{-1} t_p^dag)^T and normalized mixture weights
    (``multi_coherent.py:360-401``)."""
    na = trial.nup
    logw, sa, sb = component_log_weights(trial, phia, phib, x)
    ref = jnp.max(logw.real, axis=-1, keepdims=True)
    u = jnp.exp(logw - ref)
    comp_w = u / jnp.sum(u, axis=-1, keepdims=True)

    def greens(s, t, phi):
        eye = jnp.broadcast_to(jnp.eye(s.shape[-1], dtype=s.dtype), s.shape)
        inv = clinalg.solve(s, eye)
        phiinv = jnp.einsum("wme,wpek->wpmk", phi, inv, optimize=True)
        return jnp.einsum("wpmk,pnk->wpnm", phiinv, t.conj(), optimize=True)

    ga = greens(sa, trial.psi[:, :, :na], phia)
    gb = greens(sb, trial.psi[:, :, na:], phib)
    return jnp.stack([ga, gb], axis=2), comp_w


def mc_boson_mixture(trial: MultiCoherentTrial, phia, phib, x):
    """(gradient, lap_over_phi, comp_weights) of the phonon mixture at X.

    grad = sum_p v_p grad log phi_B,p  (coherent_state.py:549-568);
    lap_over_phi = sum_p v_p (lap phi_B,p / phi_B,p), used by the bosonic
    local energy (harmonic_oscillator.py:45-69).
    """
    logw, _, _ = component_log_weights(trial, phia, phib, x)
    ref = jnp.max(logw.real, axis=-1, keepdims=True)
    u = jnp.exp(logw - ref)
    v = u / jnp.sum(u, axis=-1, keepdims=True)            # [w, P] complex
    mw = trial.m * trial.w0
    d = x[:, None, :] - trial.shifts[None, :, :]          # [w, P, M]
    grad_p = -mw * d
    lap_p = mw * mw * d * d - mw                          # per site
    grad = jnp.einsum("wp,wpm->wm", v, grad_p.astype(v.dtype))
    lap = jnp.einsum("wp,wpm->wm", v, lap_p.astype(v.dtype))
    return grad, lap, v


def multi_coherent_trial(ham, psi_stack=None, shift_stack=None, coeffs=None,
                         precision=None, verbose: bool = False):
    """Build a multi-coherent trial.

    Without explicit stacks: variationally optimize the single coherent
    state (models/hubbard_holstein.coherent_state_trial) and symmetrize it
    over the nx*ny lattice translations with uniform coefficients.
    """
    from pauxy_jax.utils.transfer import to_device, to_host

    prec = config.get_precision(precision)
    na, nb = ham.nup, ham.ndown
    m = ham.nbasis
    if psi_stack is None:
        from pauxy_jax.models.hubbard_holstein import coherent_state_trial

        base = coherent_state_trial(ham, precision=precision)
        psia = np.asarray(to_host(base.psia))
        psib = np.asarray(to_host(base.psib))
        shift0 = np.asarray(to_host(base.shift)).real
        psi0 = np.concatenate([psia, psib], axis=1)
        perms = _translation_perms(ham)
        psi_stack = np.stack([psi0[p, :] for p in perms])
        shift_stack = np.stack([shift0[p] for p in perms])
        coeffs = np.ones(len(perms)) / np.sqrt(len(perms))
    psi_stack = np.asarray(psi_stack, dtype=prec.cplx)
    shift_stack = np.asarray(shift_stack, dtype=prec.real)
    coeffs = np.asarray(coeffs, dtype=prec.cplx)

    trial = MultiCoherentTrial(
        psi=to_device(psi_stack),
        shifts=to_device(shift_stack),
        coeffs=to_device(coeffs),
        inita=to_device(psi_stack[0, :, :na]),
        initb=to_device(psi_stack[0, :, na:]),
        shift=to_device(shift_stack[0]),
        nup=int(na),
        m=float(ham.m),
        w0=float(ham.w0),
    )
    etrial = _mc_trial_energy(ham, trial)
    if verbose:
        print(f"# Multi-coherent trial: {len(coeffs)} components, "
              f"E_T = {etrial:.8f}")
    return trial.replace(etrial=float(etrial))


def _translation_perms(ham):
    """Site permutations of the nx*ny lattice translations."""
    nx, ny = int(ham.nx), int(ham.ny)

    def site(ix, iy):
        return iy * nx + ix

    perms = []
    for dy in range(ny):
        for dx in range(nx):
            perms.append(
                np.array(
                    [
                        site((ix + dx) % nx, (iy + dy) % ny)
                        for iy in range(ny)
                        for ix in range(nx)
                    ]
                )
            )
    return perms


def _mc_trial_energy(ham, trial) -> float:
    """Variational energy of the mixture at phi = leading component,
    X = leading shift (cf. multi_coherent.py:403-418)."""
    from pauxy_jax.estimators import local_energy as le

    @jax.jit
    def compute(ham, trial):
        phia = trial.inita[None]
        phib = trial.initb[None]
        x = trial.shift[None]
        gi, comp_w = mc_greens_function(trial, phia, phib, x)
        _, lap, _ = mc_boson_mixture(trial, phia, phib, x)
        etot, _, _ = le.local_energy_multi_coherent(ham, gi, comp_w, x, lap)
        return etot.real

    return float(np.asarray(compute(ham, trial))[0])
