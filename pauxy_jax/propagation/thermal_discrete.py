"""Finite-temperature discrete-HS (Hirsch) propagation for Hubbard.

Batched counterpart of ``pauxy/thermal_propagation/hubbard.py:8-180``
(ThermalDiscrete): per time slice a sequential single-site heat-bath sweep
with rank-1 Green's-function updates

    R_s(x) = 1 + (1 - G_s[i,i]) delta[x, s],
    p(x)   = max(0, Re(R_up R_dn)) / 2,   weight *= sum_x p(x),
    G_s   <- G_s - delta/denom * outer(G_s[:, i], (e_i - G_s[i, :])),

then the slice propagator B = diag(BV) BH1 is pushed into the binned stack.

The reference wraps G slice-by-slice (BT G BT^-1) with periodic full
recomputes; here G is re-stratified from the stack at every slice, built at
the *current* slice boundary so the heat-bath ratios are exact determinant
ratios:

    A(ts) = BH1 . right . stack[block-1] ... stack[0]
               . bin_full^{nbins-1-block} . BT^{ss-1-c}

with the trailing trial powers taken from the precomputed left_table
(models/thermal_trial.py) and the future bins from the rolled stack. All
shapes are fixed (nbins+1 factors), so the whole path jits.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.walkers import thermal_state as tws


@struct.dataclass
class ThermalDiscrete:
    """Discrete HS at T > 0 (thermal_propagation/hubbard.py:8-180)."""

    BH1: jax.Array        # [2, M, M] expm(-dt (H1 - mu))
    BH1_inv: jax.Array    # [2, M, M] expm(+dt (H1 - mu))
    auxf: jax.Array       # [2, 2] field x spin
    aux_wfac: jax.Array   # [2]
    delta: jax.Array      # [2, 2] auxf - 1
    dt: float = struct.field(pytree_node=False)
    charge: bool = struct.field(pytree_node=False, default=False)
    free_projection: bool = struct.field(pytree_node=False, default=False)
    hybrid: bool = struct.field(pytree_node=False, default=False)
    # Recompute G from the stack at least every this many slices (and at
    # every bin boundary); between recomputes G is WRAPPED to the next
    # boundary, G <- BH1 G BH1^-1 (the reference's propagate_greens_function,
    # ``thermal_propagation/hubbard.py:101-104`` + its nstblz recompute) —
    # an exact similarity transform because BH1 is built at the trial's mu
    # and equals the trial B_T slice (see make_thermal_discrete). This
    # replaces a full O(nbins M^3) stratified product per slice with two
    # matmuls.
    wrap_stabilize: int = struct.field(pytree_node=False, default=10)

    # ------------------------------------------------------------------
    def _sweep_greens_function(self, trial, state, ts):
        """G at the current slice boundary with the slice's BH1 pre-applied
        (thermal.py:472-515 bin ordering, exact at bin granularity)."""
        ss = trial.stack_size
        block = ts // ss
        c = ts % ss
        nbins = state.nbins
        # Future bins first (rightmost), sampled bins, current partials.
        rolled = jnp.roll(state.stack, -(block + 1), axis=1)
        # rolled[k] for k in [0, nbins-2] = stack[(block+1+k) % nbins];
        # drop the stale current bin (it is replaced by the explicit
        # tail/right/BH1 factors) -> rolled[:, :nbins-1].
        tail = jnp.take(trial.left_table, c, axis=0)      # [2,M,M] BT^{ss-1-c}
        m = state.nbasis
        eye = jnp.eye(m, dtype=state.right.dtype)
        base = jnp.where(c == 0, eye[None, None], state.right)
        head = jnp.einsum("spm,wsmn->wspn", self.BH1, base, optimize=True)
        nw = state.nwalkers
        factors = jnp.concatenate(
            [
                jnp.broadcast_to(tail[None, None], (nw, 1, 2, m, m)),
                rolled[:, : nbins - 1],
                head[:, None],
            ],
            axis=1,
        )                                                  # [w, nbins+1, 2, M, M]
        g, _ = tws.greens_function(factors)
        return g

    def _site_sweep(self, state, g, key):
        """Sequential heat-bath site updates, batched over walkers
        (thermal_propagation/hubbard.py:94-141)."""
        m = state.nbasis
        nw = state.nwalkers
        rdtype = state.weight.dtype
        cdtype = g.dtype
        delta = self.delta.astype(cdtype)
        rs = jax.random.uniform(key, (m, nw), dtype=rdtype)

        def body(carry, inputs):
            g, weight, bv = carry
            i, r = inputs
            gii = g[:, :, i, i]                            # [w, 2]
            r1 = (1 + (1 - gii[:, 0]) * delta[0, 0]) * (
                1 + (1 - gii[:, 1]) * delta[0, 1]
            )
            r2 = (1 + (1 - gii[:, 0]) * delta[1, 0]) * (
                1 + (1 - gii[:, 1]) * delta[1, 1]
            )
            probs = 0.5 * jnp.stack([r1, r2], -1)          # [w, 2]
            pr = jnp.maximum(probs.real, 0.0)
            norm = pr.sum(-1)
            alive = (norm > 0) & (weight > 0)
            weight = jnp.where(alive, weight * norm, 0.0)
            xi = (r >= pr[:, 0] / jnp.where(norm > 0, norm, 1.0)).astype(
                jnp.int32
            )                                              # [w]
            dx = jnp.take(delta, xi, axis=0)               # [w, 2]
            g_col = g[:, :, :, i]                          # [w, 2, M]
            g_row = -g[:, :, i, :]
            g_row = g_row.at[:, :, i].add(1.0)
            denom = 1 + (1 - gii) * dx
            g = g - (dx / denom)[:, :, None, None] * (
                g_col[:, :, :, None] * g_row[:, :, None, :]
            )
            bv = bv.at[:, :, i].set(jnp.take(self.auxf.astype(cdtype), xi,
                                             axis=0))
            return (g, weight, bv), xi

        bv0 = jnp.ones((nw, 2, m), cdtype)
        (g, weight, bv), fields = jax.lax.scan(
            body,
            (g, state.weight, bv0),
            (jnp.arange(m), rs),
        )
        return g, weight, bv, jnp.swapaxes(fields, 0, 1)

    def propagate(self, trial, state, key, ts):
        """One time slice (thermal_propagation/hubbard.py:117-141)."""
        if self.free_projection:
            g = self._sweep_greens_function(trial, state, ts)
            return self._propagate_free(trial, state, g, key, ts)
        ts = jnp.asarray(ts, jnp.int32)
        # G at this slice boundary: recomputed from the stack at bin
        # boundaries / every wrap_stabilize slices, otherwise the wrapped
        # G stored by the previous slice (see wrap_stabilize docstring).
        refresh = (ts % trial.stack_size == 0) | (
            ts % self.wrap_stabilize == 0
        )
        g = jax.lax.cond(
            refresh,
            lambda _: self._sweep_greens_function(trial, state, ts),
            lambda _: state.G,
            None,
        )
        g, weight, bv, _fields = self._site_sweep(state, g, key)
        b = bv[:, :, :, None] * self.BH1[None]             # diag(BV) BH1
        state = tws.update_stack(trial, state, b, ts)
        # Wrap to the next slice boundary — except at the last slice, where
        # the swept G is the full-path estimator G (the reference's
        # time_slice < ntime_slices guard, hubbard.py:101-104).
        wrapped = jnp.einsum(
            "spm,wsmn,snq->wspq", self.BH1, g, self.BH1_inv, optimize=True
        )
        g_store = jnp.where(ts == trial.num_slices - 1, g, wrapped)
        # The constrained path's weight comes from the per-site heat-bath
        # ratios; log_m0 has no consumer here (the free-projection path
        # maintains it itself from the stack's QDT factors).
        weight = jnp.where(jnp.isfinite(weight), weight, 0.0)
        return state.replace(G=g_store, weight=weight)

    def _propagate_free(self, trial, state, g, key, ts):
        """Random fields, determinant-ratio weight with phase
        (thermal_propagation/hubbard.py:143-180)."""
        m = state.nbasis
        nw = state.nwalkers
        cdtype = state.log_m0.dtype
        fields = jax.random.randint(key, (nw, m), 0, 2)
        bv = jnp.take(self.auxf.astype(cdtype), fields, axis=0)  # [w, M, 2]
        bv = jnp.swapaxes(bv, 1, 2)                        # [w, 2, M]
        wfac = jnp.prod(jnp.take(self.aux_wfac.astype(cdtype), fields),
                        axis=-1)
        b = bv[:, :, :, None] * self.BH1[None]
        # state.log_m0 is maintained stably from the stack factors; det is
        # invariant under the cyclic rotation of g, and slogdet of the
        # assembled g would underflow at long beta.
        log_m0_old = state.log_m0
        state = tws.update_stack(trial, state, b, ts)
        g_new, log_m0_new = tws.greens_function(state.stack)
        # det(G_old)/det(G_new) = det(1 + A_new)/det(1 + A_old); the cyclic
        # rotation between the sweep boundary and boundary 0 leaves the
        # determinant unchanged.
        log_oratio = jnp.log(wfac) + jnp.sum(log_m0_old - log_m0_new, -1)
        magn = jnp.exp(log_oratio.real)
        weight = state.weight * magn
        phase = state.phase * jnp.exp(1j * log_oratio.imag).astype(cdtype)
        weight = jnp.where(jnp.isfinite(weight), weight, 0.0)
        return state.replace(
            G=g_new, log_m0=log_m0_new, weight=weight, phase=phase
        )


def make_thermal_discrete(
    ham, trial, dt: float, charge_decomposition: bool = False,
    free_projection: bool = False, mu: float | None = None,
    wrap_stabilize: int = 10, precision=None,
) -> ThermalDiscrete:
    """Build the discrete thermal propagator
    (thermal_propagation/hubbard.py:10-88). BH1 is built at the trial's mu
    (it must equal the trial B_T for the stack's left-fill algebra); a
    system mu differing from it is folded into the diagonal field factors,
    auxf *= e^{dt (mu_sys - mu_T)} (thermal_propagation/hubbard.py:41-48)."""
    prec = config.get_precision(precision)
    from pauxy_jax.utils.transfer import to_device

    u = float(ham.U)
    dmu = 0.0 if mu is None else float(mu) - float(trial.mu)
    mu = float(trial.mu)
    if charge_decomposition:
        gamma = np.arccosh(np.exp(-0.5 * dt * u + 0j))
        auxf = np.array(
            [[np.exp(gamma), np.exp(gamma)],
             [np.exp(-gamma), np.exp(-gamma)]]
        )
        aux_wfac = np.exp(0.5 * dt * u) * np.array(
            [np.exp(-gamma), np.exp(gamma)]
        )
    else:
        if u < 0:
            # Same failure mode as the T=0 path: arccosh(e^{dt U/2}) is
            # complex for attractive U, so the SPIN HS decomposition does
            # not exist (the reference silently NaNs here,
            # thermal_propagation/hubbard.py:33-40).
            raise ValueError(
                "discrete spin decomposition requires U >= 0; use "
                "propagator {'charge_decomposition': true} for attractive U"
            )
        gamma = np.arccosh(np.exp(0.5 * dt * u))
        auxf = np.array(
            [[np.exp(gamma), np.exp(-gamma)],
             [np.exp(-gamma), np.exp(gamma)]]
        )
        aux_wfac = np.array([1.0, 1.0])
    if not ham.symmetric:
        auxf = auxf * np.exp(-0.5 * dt * u)
    auxf = auxf.astype(complex) * np.exp(dt * dmu)
    h1 = np.asarray(ham.T)  # bare hopping: U handled by the fields
    eye = np.eye(ham.nbasis)
    bh1 = np.stack(
        [scipy.linalg.expm(-dt * (h1[0] - mu * eye)),
         scipy.linalg.expm(-dt * (h1[1] - mu * eye))]
    )
    bh1_inv = np.stack(
        [scipy.linalg.expm(dt * (h1[0] - mu * eye)),
         scipy.linalg.expm(dt * (h1[1] - mu * eye))]
    )
    return ThermalDiscrete(
        BH1=to_device(bh1.astype(prec.cplx)),
        BH1_inv=to_device(bh1_inv.astype(prec.cplx)),
        auxf=to_device(auxf.astype(prec.cplx)),
        aux_wfac=to_device(aux_wfac.astype(prec.cplx)),
        delta=to_device((auxf - 1).astype(prec.cplx)),
        dt=float(dt),
        charge=bool(charge_decomposition),
        free_projection=bool(free_projection),
        wrap_stabilize=max(1, int(wrap_stabilize)),
    )
