"""Multi-determinant (NOMSD) trial wavefunctions.

Batched counterpart of ``pauxy/trial_wavefunction/multi_slater.py:15-265``
(non-orthogonal determinant expansion) and the multi-determinant walker
algebra of ``pauxy/walkers/multi_det.py:8-290``. The reference keeps
per-determinant inverse overlaps and Green's functions in python lists; here
the determinant axis is just another batched tensor dimension:

  S[w, d]      = psi_d^dag phi          (batched einsum)
  logdet[w, d] (clinalg.slogdet)
  G_d[w, d]    per-determinant Green's functions
  <psi_T|phi>  = sum_d conj(c_d) det S_d  (complex log-sum-exp over d)
  G            = sum_d w_d G_d,  w_d = conj(c_d) det_d / sum_d' ...
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.ops import clinalg


@struct.dataclass
class MultiSlaterTrial:
    """NOMSD trial: |psi_T> = sum_d c_d |psi^a_d> x |psi^b_d>."""

    psia: Any              # [D, M, na]
    psib: Any              # [D, M, nb]
    coeffs: Any            # [D] complex
    inita: Any             # [M, na] initial walker determinant
    initb: Any             # [M, nb]
    # Per-determinant half-rotated Cholesky + one-body tensors (Generic
    # Hamiltonians): the fast force-bias / local-energy path
    # (multi_slater.py:267-420 half_rotate; rchol[d] = psi_d^dag L).
    rchola: Any = None     # [D, X, na, M] or None
    rcholb: Any = None     # [D, X, nb, M] or None
    rh1a: Any = None       # [D, na, M] or None
    rh1b: Any = None       # [D, nb, M] or None
    G_host: Any = struct.field(pytree_node=False, default=None)
    etrial: float = struct.field(pytree_node=False, default=0.0)
    name: str = struct.field(pytree_node=False, default="multi_slater")

    @property
    def ndets(self) -> int:
        return self.psia.shape[0]

    @property
    def nup(self) -> int:
        return self.psia.shape[-1]

    @property
    def ndown(self) -> int:
        return self.psib.shape[-1]

    @property
    def nbasis(self) -> int:
        return self.psia.shape[1]


class MultiDetGreens(NamedTuple):
    G: jax.Array          # [w, 2, M, M] det-weighted total Green's function
    Gi: jax.Array         # [w, D, 2, M, M] per-determinant
    det_weights: jax.Array  # [w, D] complex, conj(c_d) det_d / denom
    log_ovlp: jax.Array   # [w] complex log <psi_T|phi>
    Ghalfa: jax.Array = None   # [w, D, na, M] per-det half-rotated GF
    Ghalfb: jax.Array = None   # [w, D, nb, M]


def _logsumexp_c(z: jax.Array, axis=-1) -> jax.Array:
    """log sum exp for complex z (stable in the real part)."""
    m = jnp.max(z.real, axis=axis, keepdims=True)
    s = jnp.sum(jnp.exp(z - m), axis=axis)
    return jnp.squeeze(m, axis) + jnp.log(s)


def greens_function_multi_det(trial: MultiSlaterTrial, phia, phib) -> MultiDetGreens:
    """Batched multi-determinant Green's function (multi_det.py:31-150)."""

    def spin_half(phi, psi):
        s = jnp.einsum("wmi,dmj->wdij", phi, psi.conj(), optimize=True)
        logdet = clinalg.slogdet(s)                        # [w, D]
        # A walker exactly orthogonal to one determinant (det S_d = 0) makes
        # S_d singular; its det weight is 0 but inf * 0 = nan would poison
        # the weighted sum, so solve a regularised S_d and zero the result.
        singular = ~jnp.isfinite(logdet.real)              # [w, D]
        eye = jnp.eye(s.shape[-1], dtype=s.dtype)
        s_safe = jnp.where(singular[..., None, None], eye, s)
        ghalf = clinalg.solve(s_safe, jnp.swapaxes(phi, -1, -2)[:, None])
        ghalf = jnp.where(singular[..., None, None], 0.0, ghalf)
        logdet = jnp.where(singular, -1e30, logdet.real) + 1j * logdet.imag
        g = jnp.einsum("dmi,wdin->wdmn", psi.conj(), ghalf, optimize=True)
        return g, ghalf, logdet

    ga, gha, la = spin_half(phia, trial.psia)
    gb, ghb, lb = spin_half(phib, trial.psib)
    logw = la + lb + jnp.log(trial.coeffs.conj())[None, :]  # [w, D]
    log_ovlp = _logsumexp_c(logw, axis=-1)
    w_d = jnp.exp(logw - log_ovlp[:, None])                 # [w, D]
    gi = jnp.stack([ga, gb], axis=2)                        # [w, D, 2, M, M]
    g = jnp.einsum("wd,wdsmn->wsmn", w_d, gi, optimize=True)
    return MultiDetGreens(G=g, Gi=gi, det_weights=w_d, log_ovlp=log_ovlp,
                          Ghalfa=gha, Ghalfb=ghb)


def log_overlap_multi_det(trial: MultiSlaterTrial, phia, phib) -> jax.Array:
    sa = jnp.einsum("wmi,dmj->wdij", phia, trial.psia.conj(), optimize=True)
    sb = jnp.einsum("wmi,dmj->wdij", phib, trial.psib.conj(), optimize=True)
    logw = (
        clinalg.slogdet(sa) + clinalg.slogdet(sb)
        + jnp.log(trial.coeffs.conj())[None, :]
    )
    logw = jnp.where(jnp.isfinite(logw.real), logw.real, -1e30) + 1j * logw.imag
    return _logsumexp_c(logw, axis=-1)


def multi_slater_trial(ham, psi: np.ndarray, coeffs=None, init=None,
                       precision=None) -> MultiSlaterTrial:
    """Build an NOMSD trial from psi [D, M, na+nb] (+ coefficients).

    Reference: ``multi_slater.py:15-144`` (init = first determinant unless
    given, ``trial_wavefunction/utils.py:123-144``).
    """
    prec = config.get_precision(precision)
    from pauxy_jax.utils.transfer import HostArray, to_device

    psi = np.asarray(psi).astype(prec.cplx)
    d = psi.shape[0]
    na = ham.nup
    if coeffs is None:
        coeffs = np.ones(d)
    coeffs = np.asarray(coeffs).astype(prec.cplx)
    if init is None:
        # The first determinant can be exactly orthogonal to another one
        # (e.g. PHMSD identity columns); start from the dominant subspace of
        # the coefficient-weighted determinant span instead, which overlaps
        # every determinant generically.
        def span_init(block, n):
            cols = np.concatenate([block[d] for d in range(len(coeffs))],
                                  axis=1)
            # Generic (seeded) mixing: an axis-aligned subspace (plain SVD)
            # can be exactly orthogonal to a small-coefficient determinant,
            # a random combination of the span almost surely is not.
            rng = np.random.default_rng(7)
            w = rng.standard_normal((cols.shape[1], n))
            q, _ = np.linalg.qr(cols @ w)
            return q[:, :n]

        init = np.concatenate(
            [span_init(psi[:, :, :na], na), span_init(psi[:, :, na:], ham.ndown)],
            axis=1,
        )
    psia, psib = psi[:, :, :na], psi[:, :, na:]

    # Host trial Green's function + variational-ish energy from the
    # det-weighted G at phi = init (used for reporting only).
    import jax as _jax

    md = greens_function_multi_det(
        MultiSlaterTrial(
            psia=to_device(psia), psib=to_device(psib),
            coeffs=to_device(coeffs),
            inita=to_device(init[:, :na].astype(prec.cplx)),
            initb=to_device(init[:, na:].astype(prec.cplx)),
        ),
        to_device(init[None, :, :na].astype(prec.cplx)),
        to_device(init[None, :, na:].astype(prec.cplx)),
    )
    from pauxy_jax.utils.transfer import to_host

    g_host = to_host(md.G)[0]
    from pauxy_jax.estimators import local_energy as le

    try:
        etrial = float(np.real(le.local_energy_G_host(ham, g_host)[0]))
    except NotImplementedError:
        etrial = 0.0

    # Per-determinant half rotation for Generic Hamiltonians: rchol_d =
    # psi_d^dag L, rh1_d = psi_d^dag H1 — the MSD fast force-bias/energy
    # tensors (multi_slater.py:267-420; one einsum replaces the reference's
    # per-rank Cholesky column slabs).
    rchola = rcholb = rh1a = rh1b = None
    if getattr(ham, "chol", None) is not None:
        chol = np.asarray(ham.chol)                       # [M, M, X]
        h1 = np.asarray(ham.H1)
        rchola = to_device(np.einsum(
            "dpi,pmx->dxim", psia.conj(), chol, optimize=True
        ).astype(prec.cplx))
        rcholb = to_device(np.einsum(
            "dpi,pmx->dxim", psib.conj(), chol, optimize=True
        ).astype(prec.cplx))
        rh1a = to_device(np.einsum(
            "dpi,pm->dim", psia.conj(), h1[0], optimize=True
        ).astype(prec.cplx))
        rh1b = to_device(np.einsum(
            "dpi,pm->dim", psib.conj(), h1[1], optimize=True
        ).astype(prec.cplx))
    return MultiSlaterTrial(
        psia=to_device(psia),
        psib=to_device(psib),
        coeffs=to_device(coeffs),
        inita=to_device(init[:, :na].astype(prec.cplx)),
        initb=to_device(init[:, na:].astype(prec.cplx)),
        rchola=rchola,
        rcholb=rcholb,
        rh1a=rh1a,
        rh1b=rh1b,
        G_host=HostArray(g_host),
        etrial=etrial,
    )


def phmsd_trial(ham, coeffs, occa, occb, precision=None) -> MultiSlaterTrial:
    """Particle-hole MSD from occupation-number lists (CI expansions in an
    orthogonal basis). Counterpart of ``multi_slater.py:172-232``
    (from_phmsd): each determinant is a column selection of the identity.
    """
    m = ham.nbasis
    eye = np.eye(m)
    psis = []
    for oa, ob in zip(occa, occb):
        psis.append(np.concatenate([eye[:, list(oa)], eye[:, list(ob)]], axis=1))
    return multi_slater_trial(ham, np.stack(psis), np.asarray(coeffs),
                              precision=precision)


def recompute_ci_coeffs(ham, psi: np.ndarray = None, nup: int = None,
                        occa=None, occb=None):
    """Rediagonalize H in the span of the determinants (host-side).

    Counterpart of ``pauxy/trial_wavefunction/multi_slater.py:193-232``.
    Orthogonal (PHMSD) expansions — pass ``occa/occb`` occupation lists —
    use Slater-Condon matrix elements (the transition-density formula is
    undefined at <D_i|D_j> = 0); non-orthogonal expansions — pass
    ``psi [D, M, ne]`` — solve the generalized eigenproblem
    H_ij = ovlp_ij E_loc(G_ij), S_ij = ovlp_ij with zero-overlap pairs
    dropped, matching the reference's cutoff (``:216``).

    Returns (coeffs [D], e0): the ground eigenvector and eigenvalue.
    """
    import scipy.linalg

    from pauxy_jax.estimators import local_energy as le

    if occa is not None:
        from pauxy_jax.estimators.ci import fci_hamiltonian

        basis = list(zip([tuple(a) for a in occa], [tuple(b) for b in occb]))
        h, _ = fci_hamiltonian(ham, basis=basis)
        e, ev = scipy.linalg.eigh(h)
        return np.array(ev[:, 0], dtype=complex), float(e[0].real)

    psi = np.asarray(psi)
    d = psi.shape[0]
    h = np.zeros((d, d), dtype=complex)
    s = np.zeros((d, d), dtype=complex)
    for i in range(d):
        for j in range(i, d):
            dia, dib = psi[i][:, :nup], psi[i][:, nup:]
            dja, djb = psi[j][:, :nup], psi[j][:, nup:]
            oa = dia.conj().T @ dja
            ob = dib.conj().T @ djb
            ovlp = np.linalg.det(oa) * np.linalg.det(ob)
            if abs(ovlp) > 1e-12:
                ga = np.conj(dja @ np.linalg.solve(oa, dia.conj().T)).T
                gb = np.conj(djb @ np.linalg.solve(ob, dib.conj().T)).T
                etot = le.local_energy_G_host(ham, np.stack([ga, gb]))[0]
                h[i, j] = ovlp * etot
                s[i, j] = ovlp
                h[j, i] = np.conj(h[i, j])
                s[j, i] = np.conj(s[i, j])
    e, ev = scipy.linalg.eigh(h, s)
    return np.array(ev[:, 0], dtype=complex), float(e[0].real)
