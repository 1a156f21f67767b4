"""Multi-determinant GHF trial wavefunctions (Hubbard lattice models).

Batched counterpart of ``pauxy/trial_wavefunction/multi_determinant.py:9``
(the GHF 2M x ne expansion) plus the GHF walker algebra of
``pauxy/walkers/multi_ghf.py:7`` and the sweep ratios of
``pauxy/propagation/hubbard.py:483-510``.

Structure. A GHF determinant is a (2M x ne) Slater matrix mixing spin
sectors; the trial is an expansion sum_d c_d |t_d>. The *walker* stays
block-diagonal (up block [M x nup], down block [M x ndown]) throughout:
it is initialised block-diagonal, the kinetic propagator is block-diagonal,
and Hirsch site updates only scale rows within blocks
(``multi_ghf.py:137-167`` makes the same assumption). So the walker
population reuses the standard SoA ``WalkerState`` (phia/phib) and all of
pop-control/reortho/checkpoint unchanged; only overlaps, Green's functions
and local energy see the 2M x ne trial:

  S_d  = t_d^dag phi          (ne x ne, spin-mixed)
  <psi_T|phi> = sum_d conj(c_d) det S_d
  Gi_d = (phi S_d^{-1} t_d^dag)^T     (2M x 2M)

Per-walker-per-determinant algebra is batched einsums over [w, D] axes.
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
class GHFTrial:
    """Multi-determinant GHF trial: psi [D, 2M, ne], coeffs [D]."""

    psi: Any               # [D, 2M, ne] complex
    coeffs: Any            # [D] complex
    inita: Any             # [M, nup] initial walker orbitals (block-diag)
    initb: Any             # [M, ndown]
    etrial: float = struct.field(pytree_node=False, default=0.0)
    name: str = struct.field(pytree_node=False, default="multi_determinant")

    @property
    def ndets(self) -> int:
        return self.psi.shape[0]

    @property
    def nbasis(self) -> int:
        return self.psi.shape[1] // 2

    @property
    def nup(self) -> int:
        return self.inita.shape[1]

    @property
    def ndown(self) -> int:
        return self.initb.shape[1]


def ghf_overlap_matrices(trial: GHFTrial, phia, phib):
    """S[w, d] = t_d^dag phi for a block-diagonal walker ([w, D, ne, ne]).

    Columns e < nup come from the up block, e >= nup from the down block
    (``multi_ghf.py:85-97`` with phi block-diagonal).
    """
    tup = trial.psi[:, : trial.nbasis, :]                 # [D, M, ne]
    tdn = trial.psi[:, trial.nbasis :, :]
    s1 = jnp.einsum("dmk,wme->wdke", tup.conj(), phia, optimize=True)
    s2 = jnp.einsum("dmk,wme->wdke", tdn.conj(), phib, optimize=True)
    return jnp.concatenate([s1, s2], axis=-1)


def ghf_log_overlap(trial: GHFTrial, phia, phib):
    """log <psi_T|phi> = log sum_d conj(c_d) det S_d (complex logsumexp)."""
    s = ghf_overlap_matrices(trial, phia, phib)
    logdets = clinalg.slogdet(s)                          # [w, D] complex log
    logw = logdets + jnp.log(trial.coeffs.conj())[None, :]
    ref = jnp.max(logw.real, axis=-1, keepdims=True)
    return (
        jnp.log(jnp.sum(jnp.exp(logw - ref), axis=-1)) + ref[:, 0]
    )


def ghf_greens_function(trial: GHFTrial, phia, phib):
    """(Gi [w, D, 2M, 2M], det_weights [w, D]) for a block-diagonal walker.

    Gi_d = (phi S_d^{-1} t_d^dag)^T (``multi_ghf.py:169-184``);
    det_weights_d = conj(c_d) det S_d / sum (so G = sum_d w_d Gi_d).
    """
    nup = trial.nup
    s = ghf_overlap_matrices(trial, phia, phib)
    ne = s.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(ne, dtype=s.dtype), s.shape)
    inv = clinalg.solve(s, eye)                           # [w, D, ne, ne]
    logdets = clinalg.slogdet(s)
    logw = logdets + jnp.log(trial.coeffs.conj())[None, :]
    ref = jnp.max(logw.real, axis=-1, keepdims=True)
    w_un = jnp.exp(logw - ref)
    det_weights = w_un / jnp.sum(w_un, axis=-1, keepdims=True)

    # phi @ inv, block rows ([w, D, 2M, ne]).
    up = jnp.einsum("wme,wdek->wdmk", phia, inv[:, :, :nup, :], optimize=True)
    dn = jnp.einsum("wme,wdek->wdmk", phib, inv[:, :, nup:, :], optimize=True)
    phiinv = jnp.concatenate([up, dn], axis=2)
    gi = jnp.einsum("wdyk,dxk->wdxy", phiinv, trial.psi.conj(), optimize=True)
    return gi, det_weights


def ghf_trial_from_uhf(ham, psia: np.ndarray, psib: np.ndarray,
                       precision=None) -> GHFTrial:
    """Block-embed a UHF determinant pair into a single GHF determinant."""
    prec = config.get_precision(precision)
    m = psia.shape[0]
    na, nb = psia.shape[1], psib.shape[1]
    psi = np.zeros((1, 2 * m, na + nb), dtype=prec.cplx)
    psi[0, :m, :na] = psia
    psi[0, m:, na:] = psib
    return make_ghf_trial(ham, psi, np.ones((1,)), precision=precision)


def read_fortran_complex_numbers(filename: str) -> np.ndarray:
    """Parse the reference's '(re,im)'-per-line GHF orbital/coefficient files
    (``pauxy/utils/io.py:21-29``)."""
    import ast

    with open(filename) as f:
        vals = [ast.literal_eval(line.strip()) for line in f if line.strip()]
    return np.array([complex(t[0], t[1]) for t in vals])


def ghf_trial_from_files(ham, orbital_file: str, coeffs_file: str,
                         ndets: int, precision=None) -> GHFTrial:
    """Read the reference ascii format (``multi_determinant.py:72-84``):
    column-major (2M x ne) blocks per determinant."""
    coeffs = read_fortran_complex_numbers(coeffs_file)[:ndets]
    orbs = read_fortran_complex_numbers(orbital_file)
    m2, ne = 2 * ham.nbasis, ham.nup + ham.ndown
    psi = np.zeros((ndets, m2, ne), dtype=complex)
    skip = m2 * ne
    for d in range(ndets):
        psi[d] = orbs[d * skip : (d + 1) * skip].reshape((m2, ne), order="F")
    return make_ghf_trial(ham, psi, coeffs, precision=precision)


def make_ghf_trial(ham, psi: np.ndarray, coeffs: np.ndarray,
                   init=None, precision=None) -> GHFTrial:
    """Build the trial pytree; initial walker defaults to the free-electron
    block determinant (``multi_ghf.py:35-45``)."""
    from pauxy_jax.utils.transfer import to_device

    prec = config.get_precision(precision)
    psi = np.asarray(psi, dtype=prec.cplx)
    coeffs = np.asarray(coeffs, dtype=prec.cplx)
    m = psi.shape[1] // 2
    na, nb = ham.nup, ham.ndown
    if init is not None:
        inita, initb = init
    else:
        from pauxy_jax.models.trial import free_electron_trial

        fe = free_electron_trial(ham, precision=precision)
        from pauxy_jax.utils.transfer import to_host

        inita = to_host(fe.psia)
        initb = to_host(fe.psib)
    inita = np.asarray(inita, dtype=prec.cplx)
    initb = np.asarray(initb, dtype=prec.cplx)

    # True variational energy of the expansion (GAB-full,
    # estimators/hubbard.py:145-176; the reference's multi_determinant
    # trial instead reports the mixed energy of the leading pair,
    # multi_determinant.py:86-93).
    etrial = ghf_variational_energy(ham, psi, coeffs)
    return GHFTrial(
        psi=to_device(psi),
        coeffs=to_device(coeffs),
        inita=to_device(inita),
        initb=to_device(initb),
        etrial=etrial,
    )


def ghf_variational_energy(ham, psi, coeffs) -> float:
    """True variational energy of the GHF expansion,
    <Psi|H|Psi> / <Psi|Psi> with cross-determinant Green's functions
    GAB_dd' (``pauxy/estimators/hubbard.py:145-176``
    local_energy_hubbard_ghf_full). Host-side numpy (setup only)."""
    psi = np.asarray(psi)
    coeffs = np.asarray(coeffs)
    d = psi.shape[0]
    m = psi.shape[1] // 2
    t = np.asarray(ham.T)
    text = np.block([[t[0], np.zeros_like(t[0])],
                     [np.zeros_like(t[1]), t[1]]])
    num = 0.0 + 0j
    denom = 0.0 + 0j
    for a in range(d):
        for b in range(d):
            s = psi[a].conj().T @ psi[b]
            ovlp = np.linalg.det(s)
            if abs(ovlp) < 1e-14:
                continue
            w = coeffs[a].conj() * coeffs[b] * ovlp
            gab = (psi[b] @ np.linalg.solve(s, psi[a].conj().T)).T
            ke = np.sum(gab * text)
            guu = np.diagonal(gab[:m, :m])
            gdd = np.diagonal(gab[m:, m:])
            gud = np.diagonal(gab[m:, :m])
            gdu = np.diagonal(gab[:m, m:])
            pe = ham.U * np.sum(guu * gdd - gud * gdu)
            num += w * (ke + pe)
            denom += w
    return float(np.real(num / denom))


def _ghf_energy_host(ham, psi, coeffs, phia, phib):
    """Host-side GHF local energy of a block-diagonal walker (setup only)."""
    m = psi.shape[1] // 2
    na = phia.shape[1]
    d = psi.shape[0]
    s = np.concatenate(
        [
            np.einsum("dmk,me->dke", psi[:, :m, :].conj(), phia),
            np.einsum("dmk,me->dke", psi[:, m:, :].conj(), phib),
        ],
        axis=-1,
    )
    dets = np.array([np.linalg.det(s[i]) for i in range(d)])
    wts = coeffs.conj() * dets
    denom = wts.sum()
    inv = np.array([np.linalg.inv(s[i]) for i in range(d)])
    up = np.einsum("me,dek->dmk", phia, inv[:, :na, :])
    dn = np.einsum("me,dek->dmk", phib, inv[:, na:, :])
    phiinv = np.concatenate([up, dn], axis=1)
    gi = np.einsum("dyk,dxk->dxy", phiinv, psi.conj())
    t = np.asarray(ham.T)
    text = np.block(
        [[t[0], np.zeros_like(t[0])], [np.zeros_like(t[1]), t[1]]]
    )
    ke = np.einsum("d,dkl,kl->", wts, gi, text) / denom
    guu = np.einsum("dii->di", gi[:, :m, :m])
    gdd = np.einsum("dii->di", gi[:, m:, m:])
    gud = np.einsum("dii->di", gi[:, m:, :m])
    gdu = np.einsum("dii->di", gi[:, :m, m:])
    pe = ham.U * np.einsum("d,di->", wts, guu * gdd - gud * gdu) / denom
    return ke + pe
