"""Continuous HS propagator for the UEG (plane waves).

Batched counterpart of ``pauxy/propagation/planewave.py:11-140``. The
reference contracts scipy-sparse iA/iB operators per walker; here the
density operators stay sparse (``ops/ueg_sparse.SparseRho``): force bias is
a masked gather over the kpq index map, and VHS is a sorted segment-sum
scatter of the per-q coefficients,

  iA_q = i (rho_q + rho_q^dagger),  iB_q = -(rho_q - rho_q^dagger)
  VHS  = sqrt(dt) sum_q [ (i x+_q - x-_q) rho_q + (i x+_q + x-_q) rho_q^T ]

(rho is real, so rho^dagger = rho^T). Mean-field shift is zero
(``planewave.py:25``).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.ops import ueg_sparse
from pauxy_jax.propagation.generic import apply_exponential_taylor


@struct.dataclass
class PlaneWave:
    """Inner propagator for the UEG."""

    BH1: jax.Array        # [2, M] DIAGONAL of expm(-dt/2 h1e_mod)
    mf_shift: jax.Array   # [2 nq] zeros (planewave.py:25)
    sp: ueg_sparse.SparseRho
    gmap: jax.Array = None       # FFT-cube embeddings for the pseudo-
    qmap_fft: jax.Array = None   # spectral force bias (ueg_kernels.pyx:77)
    dt: float = struct.field(pytree_node=False, default=0.0)
    qmesh: tuple = struct.field(pytree_node=False, default=None)
    exp_order: int = struct.field(pytree_node=False, default=6)

    @property
    def sqrt_dt(self):
        return self.dt ** 0.5

    @property
    def nq(self):
        return self.sp.nq

    def force_bias(self, trial, ga, gb):
        """-sqrt(dt) * (Gvec . iA, Gvec . iB)  (planewave.py:57-77).

        With FFT maps and half-rotated G available, <rho_q>/<rho_q^T> come
        from pseudo-spectral Coulomb correlations — O(w nocc Ng log Ng)
        instead of the O(w nq M) gather (which moves ~GBs of G copies per
        step at production basis sizes)."""
        if self.qmesh is not None and getattr(ga, "Ghalf", None) is not None:
            from pauxy_jax.estimators.local_energy import fft_coulomb_terms

            ka, pa = fft_coulomb_terms(trial.psia, ga.Ghalf, self.gmap,
                                       self.qmap_fft, self.qmesh)
            kb, pb = fft_coulomb_terms(trial.psib, gb.Ghalf, self.gmap,
                                       self.qmap_fft, self.qmesh)
            t1 = self.sp.qfac * (ka + kb)
            t2 = self.sp.qfac * (pa + pb)
        else:
            t1, t2 = ueg_sparse.rho_expectations(self.sp, ga.G + gb.G)
        vplus = 1j * (t1 + t2)
        vminus = -(t1 - t2)
        return -self.sqrt_dt * jnp.concatenate([vplus, vminus], axis=-1)

    def build_vhs(self, xshifted):
        """VHS = sqrt(dt)(iA x+ + iB x-), batched [w, M, M]
        (planewave.py:94-112)."""
        xa = xshifted[:, : self.nq]
        xb = xshifted[:, self.nq :]
        c1 = 1j * xa - xb          # coefficient of rho_q
        c2 = 1j * xa + xb          # coefficient of rho_q^T
        return self.sqrt_dt * ueg_sparse.assemble_vhs(self.sp, c1, c2)

    def apply_vhs(self, phia, phib, xshifted):
        vhs = self.build_vhs(xshifted)
        # Spin-independent VHS: one Taylor series on the column-concatenated
        # walker matrix (cf. propagation/generic.py).
        na = phia.shape[-1]
        phi_in = jnp.concatenate([phia, phib], axis=-1)
        phi = apply_exponential_taylor(vhs, phi_in, self.exp_order)
        return phi[..., :na], phi[..., na:]

    def bp_dagger_fields(self, x):
        """iA is anti-Hermitian (x+ -> -conj), iB is Hermitian (x- -> +conj)."""
        xa = x[:, : self.nq]
        xb = x[:, self.nq :]
        return jnp.concatenate([-xa.conj(), xb.conj()], axis=-1)


def make_planewave(ham, trial, dt: float, precision=None,
                   exp_order=6) -> PlaneWave:
    """BH1 = expm(-dt/2 h1e_mod) (planewave.py:39-55; h1e_mod is diagonal so
    this is an exact diagonal exponential, stored as a [2, M] diagonal and
    applied elementwise — the dense [M, M] matmul form cost a full
    GEMM per half-step for a multiply)."""
    prec = config.get_precision(precision)
    h1 = np.asarray(ham.h1e_mod)
    bh1 = np.stack(
        [
            np.exp(-0.5 * dt * np.diagonal(h1[0])),
            np.exp(-0.5 * dt * np.diagonal(h1[1])),
        ]
    )
    from pauxy_jax.utils.transfer import to_device, device_zeros

    fft_kw = {}
    if getattr(ham, "qmesh", None) is not None:
        fft_kw = dict(
            gmap=jnp.asarray(np.asarray(ham.gmap)),
            qmap_fft=jnp.asarray(np.asarray(ham.qmap)),
            qmesh=tuple(ham.qmesh),
        )
    return PlaneWave(
        BH1=to_device(bh1.astype(prec.cplx)),
        mf_shift=device_zeros((2 * ham.nq,), prec.cplx),
        sp=ueg_sparse.make_sparse_rho(ham, prec.real),
        dt=float(dt),
        exp_order=int(exp_order),
        **fft_kw,
    )
