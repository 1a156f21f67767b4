"""Continuous HS propagator for the Generic (Cholesky) Hamiltonian.

Batched counterpart of ``pauxy/propagation/generic.py:10-179``
(GenericContinuous). The per-walker VHS construction and the 6-term Taylor
exponential application (``pauxy/propagation/continuous.py:82-111``) are
batched: VHS build is one [w,X] x [X,M^2] matmul, the Taylor series is
exp_order batched [w,M,M] x [w,M,n] matmuls.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config


def apply_exponential_taylor(vhs: jax.Array, phi: jax.Array, order: int = 6):
    """phi <- exp(VHS) phi via the truncated Taylor series.

    vhs: [w, M, M], phi: [w, M, n]. Reference: ``continuous.py:82-111``
    (exp_nmax default 6, ``continuous.py:37``).
    """

    def body(n, carry):
        temp, acc = carry
        temp = jnp.einsum("wpq,wqn->wpn", vhs, temp, optimize=True) / n
        return temp, acc + temp

    _, phi = jax.lax.fori_loop(1, order + 1, body, (phi, phi))
    return phi


def apply_exponential_taylor_3m(vhs: jax.Array, phi: jax.Array,
                                order: int = 6):
    """Same series with the complex product done as an explicit 3M
    (Karatsuba) split: p1 = Vr Tr, p2 = Vi Ti, p3 = (Vr+Vi)(Tr+Ti) — three
    real batched GEMMs instead of XLA's complex lowering (four). An
    explicitly selectable variant (``taylor_impl='xla_3m'``), not a
    default.
    """
    vr, vi = vhs.real, vhs.imag

    def body(k, carry):
        tr, ti, ar, ai = carry
        p1 = jnp.einsum("wpq,wqn->wpn", vr, tr, optimize=True)
        p2 = jnp.einsum("wpq,wqn->wpn", vi, ti, optimize=True)
        p3 = jnp.einsum("wpq,wqn->wpn", vr + vi, tr + ti, optimize=True)
        tr, ti = (p1 - p2) / k, (p3 - p1 - p2) / k
        return tr, ti, ar + tr, ai + ti

    tr, ti = phi.real, phi.imag
    _, _, ar, ai = jax.lax.fori_loop(1, order + 1, body, (tr, ti, tr, ti))
    return (ar + 1j * ai).astype(phi.dtype)


@struct.dataclass
class GenericContinuous:
    """Inner propagator for the ab-initio Hamiltonian."""

    BH1: jax.Array        # [2, M, M]
    mf_shift: jax.Array   # [X] complex: i sum_ik L[i,k,x] (G0+G1)[i,k]
    chol: jax.Array       # [M, M, X] (alias of ham.chol; same buffer)
    dt: float = struct.field(pytree_node=False)
    exp_order: int = struct.field(pytree_node=False, default=6)
    # Taylor expm-apply: 'xla' (complex batched einsum per order) or
    # 'xla_3m' (explicit 3-real-GEMM Karatsuba complex product, see
    # apply_exponential_taylor_3m).
    taylor_impl: str = struct.field(pytree_node=False, default="xla")

    @property
    def sqrt_dt(self):
        return self.dt ** 0.5

    def force_bias(self, trial, ga, gb):
        """xbar = -sqrt(dt) (i vbias - mf_shift) with vbias from the
        half-rotated Cholesky tensors (``generic.py:130-152``); for MSD
        trials the per-determinant half-rotated path, det-weighted
        (vbias = sum_d w_d tr(rchol_d Ghalf_d) — O(D X n M) instead of the
        reference's O(nfields M^2) full-G contraction at
        ``generic.py:154-157``). Falls back to the full Green's function
        when no half-rotation exists (``generic.py:109-128`` slow path)."""
        from pauxy_jax.ops.contract import cr_einsum

        rca = getattr(trial, "rchola", None)
        if ga.Ghalf is None or rca is None:
            m = self.BH1.shape[-1]
            vbias = cr_einsum(
                "pqx,wpq->wx", self.chol.reshape(m, m, -1), ga.G + gb.G,
                optimize=True,
            )
        elif ga.Ghalf.ndim == 4:
            wd = ga.det_weights[..., None, None]          # [w, D, 1, 1]
            vbias = cr_einsum(
                "dxim,wdim->wx", rca, wd * ga.Ghalf, optimize=True
            ) + cr_einsum(
                "dxim,wdim->wx", trial.rcholb, wd * gb.Ghalf, optimize=True
            )
        else:
            vbias = cr_einsum(
                "xim,wim->wx", rca, ga.Ghalf, optimize=True
            ) + cr_einsum("xim,wim->wx", trial.rcholb, gb.Ghalf,
                          optimize=True)
        return -self.sqrt_dt * (1j * vbias - self.mf_shift)

    def apply_vhs(self, phia, phib, xshifted):
        """VHS = i sqrt(dt) sum_x L_x (x - xbar)_x, then Taylor-apply.

        Reference: ``generic.py:164-179`` + ``continuous.py:82-111``.
        """
        from pauxy_jax.ops.contract import cr_einsum

        m = phia.shape[1]
        # The i sqrt(dt) scalar rides on the [w, X] fields, not on the
        # [w, M, M] product — same contraction, one less full-size
        # pointwise pass over VHS.
        vhs = cr_einsum(
            "pqx,wx->wpq",
            self.chol.reshape(m, m, -1),
            (1j * self.sqrt_dt) * xshifted,
            optimize=True,
        )
        # VHS is spin-independent: apply one Taylor series to the
        # column-concatenated [w, M, na+nb] matrix — halves the number of
        # (narrow-n) batched matmuls vs per-spin application.
        na = phia.shape[-1]
        phi_in = jnp.concatenate([phia, phib], axis=-1)
        if self.taylor_impl == "xla_3m":
            phi = apply_exponential_taylor_3m(vhs, phi_in, self.exp_order)
        else:
            phi = apply_exponential_taylor(vhs, phi_in, self.exp_order)
        return phi[..., :na], phi[..., na:]

    def bp_dagger_fields(self, x):
        """Fields y with exp(VHS(y)) = exp(VHS(x))^dagger.

        VHS = i sqrt(dt) sum_n L_n x_n with Hermitian L_n -> y = -conj(x).
        """
        return -x.conj()


def construct_mean_field_shift(ham, trial) -> np.ndarray:
    """mf_shift_x = i sum_ik L[i,k,x] (G_T0 + G_T1)[i,k]  (generic.py:66-80)."""
    g = np.asarray(trial.G_host.arr)
    chol = np.asarray(ham.chol)
    return 1j * np.einsum("ikx,ik->x", chol, g[0] + g[1], optimize=True)


def make_generic_continuous(ham, trial, dt: float, precision=None, exp_order=6,
                            taylor_impl: str | None = None):
    """Host-side setup (``generic.py:29-107``):

    BH1_s = expm(-dt/2 (h1e_mod_s - i sum_x mf_x L_x)).
    """
    prec = config.get_precision(precision)
    if taylor_impl not in (None, "xla", "xla_3m"):
        raise ValueError(f"unknown taylor_impl {taylor_impl!r}")
    mf_shift = construct_mean_field_shift(ham, trial)
    chol = np.asarray(ham.chol)
    shift = 1j * np.einsum("pqx,x->pq", chol, mf_shift, optimize=True)
    h1 = np.asarray(ham.h1e_mod) - shift[None]
    bh1 = np.stack(
        [scipy.linalg.expm(-0.5 * dt * h1[0]), scipy.linalg.expm(-0.5 * dt * h1[1])]
    )
    from pauxy_jax.utils.transfer import to_device

    # chol keeps its NATURAL dtype (real for molecular Hamiltonians): the
    # VHS/force-bias contractions then run as two real matmuls instead
    # of four, on half the weight bytes (ops/contract.cr_einsum).
    chol_dtype = prec.cplx if np.iscomplexobj(chol) else prec.real
    return GenericContinuous(
        BH1=to_device(bh1.astype(prec.cplx)),
        mf_shift=to_device(mf_shift.astype(prec.cplx)),
        chol=to_device(chol.astype(chol_dtype)),
        dt=float(dt),
        exp_order=int(exp_order),
        taylor_impl=taylor_impl or "xla",
    )


def mf_core(ham, mf_shift: np.ndarray) -> complex:
    """ecore + 0.5 mf.mf (generic.py:49)."""
    return ham.ecore + 0.5 * np.dot(mf_shift, mf_shift)
