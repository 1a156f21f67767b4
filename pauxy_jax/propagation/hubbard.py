"""Continuous Hubbard-Stratonovich propagators for the Hubbard model.

Batched counterparts of ``pauxy/propagation/hubbard.py:346-480``
(HubbardContinuous — charge decomposition, HubbardContinuousSpin — spin
decomposition). The HS potential is diagonal in the site basis, so
exp(VHS) is applied exactly as an elementwise gauge factor (the reference
routes it through the generic 6-term Taylor expansion).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config


@struct.dataclass
class HubbardContinuous:
    """Charge-decomposition continuous HS propagator.

    v_i = i sqrt(U) (n_iu + n_id); one auxiliary field per site.
    Reference: ``pauxy/propagation/hubbard.py:346-419``.
    """

    BH1: jax.Array        # [2, M, M] exp(-dt/2 (h1e_mod - iu diag(mf_shift)))
    mf_shift: jax.Array   # [M] complex, i sqrt(U) <n_iu + n_id>_T
    dt: float = struct.field(pytree_node=False)
    U: float = struct.field(pytree_node=False)
    charge: bool = struct.field(pytree_node=False, default=True)

    @property
    def sqrt_dt(self):
        return self.dt ** 0.5

    @property
    def mf_core(self):
        # 0.5 mf_shift . mf_shift (hubbard.py:384)
        return 0.5 * jnp.dot(self.mf_shift, self.mf_shift)

    def force_bias(self, trial, ga, gb):
        """xbar = -sqrt(dt) (i sqrt(U)(diag Ga + diag Gb) - mf_shift).

        Reference: ``hubbard.py:405-408`` (charge) / ``:470-474`` (spin).
        """
        da = jnp.diagonal(ga.G, axis1=-2, axis2=-1)
        db = jnp.diagonal(gb.G, axis1=-2, axis2=-1)
        if self.charge:
            vbias = 1j * self.U ** 0.5 * (da + db)
        else:
            vbias = self.U ** 0.5 * (da - db)
        return -self.sqrt_dt * (vbias - self.mf_shift)

    def apply_vhs(self, phia, phib, xshifted):
        """phi <- exp(VHS) phi with diagonal VHS (exact, no Taylor).

        Charge: VHS = sqrt(dt) i sqrt(U) diag(x) acting identically on both
        spins (``hubbard.py:410-414``). Spin: VHS = +/- sqrt(dt U) diag(x)
        with opposite sign per spin (``hubbard.py:476-480``).
        """
        if self.charge:
            gauge = jnp.exp(self.sqrt_dt * 1j * self.U ** 0.5 * xshifted)
            return phia * gauge[:, :, None], phib * gauge[:, :, None]
        # Spin decomposition: VHS = [diag(-sqrt(dt U) x), diag(+sqrt(dt U) x)]
        # (hubbard.py:475-480).
        gauge = jnp.exp((self.dt * self.U) ** 0.5 * xshifted)
        return phia / gauge[:, :, None], phib * gauge[:, :, None]

    def bp_dagger_fields(self, x):
        """exp(VHS(y)) = exp(VHS(x))^dagger: charge generator is
        anti-Hermitian (i sqrt(U) n) -> y = -conj(x); spin generator is
        Hermitian (+/- sqrt(U) n) -> y = +conj(x)."""
        return -x.conj() if self.charge else x.conj()


def make_hubbard_continuous(
    ham, trial, dt: float, charge_decomposition: bool = True, precision=None
) -> HubbardContinuous:
    """Build the propagator (host-side expm, as setup — not the hot path).

    Charge decomposition (``hubbard.py:369-401``):
      mf_shift_i = i sqrt(U) (G_T[0] + G_T[1])_ii
      BH1 = expm(-dt/2 (h1e_mod - i sqrt(U) diag(mf_shift)))
    Spin decomposition (``hubbard.py:434-466``):
      mf_shift_i = sqrt(U) (G_T[0] - G_T[1])_ii
      BH1 = expm(-dt/2 (H1 + U/2 - sqrt(U) diag(mf_shift)))
    """
    prec = config.get_precision(precision)
    from pauxy_jax.utils.transfer import to_device

    g = np.asarray(trial.G_host.arr)
    da, db = np.diagonal(g[0]), np.diagonal(g[1])
    if charge_decomposition:
        iu = 1j * ham.U ** 0.5
        mf_shift = iu * (da + db)
        h1 = np.asarray(ham.h1e_mod) - iu * np.diag(mf_shift)[None]
    else:
        mf_shift = ham.U ** 0.5 * (da - db)
        eye = np.eye(ham.nbasis)
        h1 = (
            np.asarray(ham.T)
            + 0.5 * ham.U * eye[None]
            - ham.U ** 0.5 * np.diag(mf_shift)[None]
        )
    bh1 = np.stack(
        [scipy.linalg.expm(-0.5 * dt * h1[0]), scipy.linalg.expm(-0.5 * dt * h1[1])]
    )
    return HubbardContinuous(
        BH1=to_device(bh1.astype(prec.cplx)),
        mf_shift=to_device(mf_shift.astype(prec.cplx)),
        dt=float(dt),
        U=float(ham.U),
        charge=bool(charge_decomposition),
    )
