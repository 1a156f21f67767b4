"""Discrete-HS propagation for the Hubbard-Holstein model (electrons +
drift-diffusion DMC phonon moves).

Batched counterpart of ``pauxy/propagation/hubbard_holstein.py:17-515``
(HirschDMC). Per step (non-symmetric Trotter, the reference default,
``hubbard_holstein.py:430-438``):

  1. electron kinetic+e-ph half step (dt/2), real-part/cosine constraint
  2. Hirsch single-site sweep for the U term (reused from hirsch.py)
  3. second electron half step
  4. phonon drift-diffusion move with DMC weight
     w *= exp(-dt/2 (E_B(X') + E_B(X) - 2 E_B^shift))  (:314-356)

The reference exponentiates the coupled matrix expm(-dt(T - cpl diag X))
per walker per step with scipy (``:380-383``); here the equivalent-order
symmetric split diag(e^{dt cpl X/2}) expm(-dt T) diag(e^{dt cpl X/2}) keeps
it batched matmuls.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.models import hubbard_holstein as hh
from pauxy_jax.ops import clinalg
from pauxy_jax.propagation.hirsch import Hirsch, make_hirsch


@struct.dataclass
class HirschDMC:
    """Hirsch electron updates + DMC phonons."""

    hirsch: Hirsch        # provides auxf/aux_wfac/_site_sweep
    BT_half: jax.Array    # [2, M, M] expm(-(dt/2) T)
    dt: float = struct.field(pytree_node=False)
    m: float = struct.field(pytree_node=False)
    w0: float = struct.field(pytree_node=False)
    cpl: float = struct.field(pytree_node=False)   # g sqrt(2 m w0)
    eshift_boson: float = struct.field(pytree_node=False, default=0.0)
    free_projection: bool = struct.field(pytree_node=False, default=False)
    hybrid: bool = struct.field(pytree_node=False, default=False)
    # Symmetric Trotter ordering: boson(dt/2) electron-block boson(dt/2)
    # instead of electron-block boson(dt)
    # (``hubbard_holstein.py:419-438`` symmetric_trotter option).
    symmetric_trotter: bool = struct.field(pytree_node=False, default=False)

    # ------------------------------------------------------------------
    def _electron_half_step(self, trial, state, dt_half):
        """phi <- diag(e^{k X/2}) B_T diag(e^{k X/2}) phi with
        k = dt_half*cpl, then the magnitude*cosine constraint
        (hubbard_holstein.py:358-400)."""
        gauge = jnp.exp(0.5 * dt_half * self.cpl * state.X)  # [w, M] real
        phia = state.phia * gauge[:, :, None]
        phib = state.phib * gauge[:, :, None]
        phia = jnp.einsum("pm,wmn->wpn", self.BT_half[0], phia, optimize=True)
        phib = jnp.einsum("pm,wmn->wpn", self.BT_half[1], phib, optimize=True)
        phia = phia * gauge[:, :, None]
        phib = phib * gauge[:, :, None]
        sa = jnp.einsum("wmi,mj->wij", phia, trial.psia.conj())
        sb = jnp.einsum("wmi,mj->wij", phib, trial.psib.conj())
        log_new = (clinalg.slogdet(sa) + clinalg.slogdet(sb)).astype(
            state.log_ovlp.dtype
        )
        ratio = jnp.exp(log_new - state.log_ovlp)
        phase = jnp.angle(ratio)
        ok = jnp.abs(phase) < 0.5 * jnp.pi
        cosine = jnp.maximum(0.0, jnp.cos(phase))
        weight = jnp.where(ok, state.weight * jnp.abs(ratio) * cosine, 0.0)
        return state.replace(phia=phia, phib=phib, weight=weight,
                             log_ovlp=log_new)

    def _boson_move(self, trial, state, key, dt):
        """Drift-diffusion phonon move + DMC weight
        (hubbard_holstein.py:314-356)."""
        shift = trial.shift
        x = state.X
        eloc_old = hh.ho_local_energy(x, self.m, self.w0, shift)
        drift = (dt / self.m) * hh.ho_gradient(x, self.m, self.w0, shift)
        dx = jax.random.normal(key, x.shape, dtype=x.dtype) * jnp.sqrt(
            dt / self.m
        )
        x_new = x + dx + drift
        eloc_new = hh.ho_local_energy(x_new, self.m, self.w0, shift)
        log_ratio = hh.ho_log_value(x_new, self.m, self.w0, shift) - (
            hh.ho_log_value(x, self.m, self.w0, shift)
        )
        weight = state.weight * jnp.exp(
            -0.5 * dt * (eloc_new.real + eloc_old.real - 2 * self.eshift_boson)
        )
        return state.replace(
            X=x_new,
            weight=weight,
            log_ovlp=state.log_ovlp + log_ratio.astype(state.log_ovlp.dtype),
        )

    # ------------------------------------------------------------------
    # Multi-coherent-state paths (pauxy/walkers/multi_coherent.py +
    # coherent_state.py:530-600 mixture value/gradient).
    # ------------------------------------------------------------------
    def _electron_half_step_mc(self, trial, state, dt_half):
        from pauxy_jax.models import multi_coherent as mc

        gauge = jnp.exp(0.5 * dt_half * self.cpl * state.X)
        phia = state.phia * gauge[:, :, None]
        phib = state.phib * gauge[:, :, None]
        phia = jnp.einsum("pm,wmn->wpn", self.BT_half[0], phia, optimize=True)
        phib = jnp.einsum("pm,wmn->wpn", self.BT_half[1], phib, optimize=True)
        phia = phia * gauge[:, :, None]
        phib = phib * gauge[:, :, None]
        log_new = mc.mc_log_overlap(trial, phia, phib, state.X).astype(
            state.log_ovlp.dtype
        )
        ratio = jnp.exp(log_new - state.log_ovlp)
        phase = jnp.angle(ratio)
        ok = jnp.abs(phase) < 0.5 * jnp.pi
        cosine = jnp.maximum(0.0, jnp.cos(phase))
        weight = jnp.where(ok, state.weight * jnp.abs(ratio) * cosine, 0.0)
        return state.replace(phia=phia, phib=phib, weight=weight,
                             log_ovlp=log_new)

    def _site_sweep_mc(self, trial, state, key):
        """Hirsch site sweep against the multi-component mixture: per-site
        heat-bath ratio R(x) = sum_p u_p R_p(x) / sum_p u_p
        (``hubbard_holstein.py:546-575`` calculate_overlap_ratio_multi_det),
        with per-component spin inverses maintained by Sherman-Morrison."""
        from pauxy_jax.models import multi_coherent as mc

        hirsch = self.hirsch
        m = state.nbasis
        nw = state.nwalkers
        na = trial.nup
        cdtype = state.phia.dtype
        rdtype = state.weight.dtype
        delta = hirsch.delta
        ta = trial.psi[:, :, :na].conj()                  # [P, M, na]
        tb = trial.psi[:, :, na:].conj()

        logw, sa, sb = mc.component_log_weights(
            trial, state.phia, state.phib, state.X
        )
        eye_a = jnp.broadcast_to(jnp.eye(sa.shape[-1], dtype=cdtype), sa.shape)
        eye_b = jnp.broadcast_to(jnp.eye(sb.shape[-1], dtype=cdtype), sb.shape)
        inva = clinalg.solve(sa, eye_a)                   # [w, P, na, na]
        invb = clinalg.solve(sb, eye_b)
        ref = jnp.max(logw.real, axis=-1, keepdims=True)
        ots = jnp.exp(logw - ref)                         # scale-free u_p
        ot = jnp.sum(ots, axis=-1)

        rs = jax.random.uniform(key, (m, nw), dtype=rdtype)

        def body(carry, inputs):
            phia, phib, inva, invb, ots, ot, weight, dlog = carry
            i, r = inputs
            row_a = jnp.take(phia, i, axis=1)             # [w, na]
            row_b = jnp.take(phib, i, axis=1)
            tai = jnp.take(ta, i, axis=1)                 # [P, na] conj'd
            tbi = jnp.take(tb, i, axis=1)
            # G_ss^p(i,i) = t_s*[i] . (S_p^-T phi_s[i]).
            qa = jnp.einsum("wpba,wb->wpa", inva, row_a)
            qb = jnp.einsum("wpba,wb->wpa", invb, row_b)
            ga = jnp.einsum("pa,wpa->wp", tai, qa)
            gb = jnp.einsum("pa,wpa->wp", tbi, qb)
            r_p = (
                (1 + delta[:, 0][None, None] * ga[..., None])
                * (1 + delta[:, 1][None, None] * gb[..., None])
            )                                             # [w, P, 2]
            rtot = jnp.einsum("wpx,wp->wx", r_p, ots) / ot[:, None]
            probs = 0.5 * rtot * hirsch.aux_wfac[None, :]
            pr = jnp.maximum(probs.real, 0.0)
            norm = pr.sum(-1)
            alive = (norm > 0) & (jnp.abs(weight) > 0)
            safe_norm = jnp.where(alive, norm, 1.0)
            xi = (r >= pr[:, 0] / safe_norm).astype(jnp.int32)
            weight = jnp.where(alive, weight * norm, 0.0)
            chosen = jnp.take_along_axis(rtot, xi[:, None], axis=1)[:, 0]
            dlog = dlog + jnp.where(
                alive, jnp.log(chosen.astype(cdtype)), 0.0
            )
            da = jnp.where(alive, delta[xi, 0], 0.0)
            db = jnp.where(alive, delta[xi, 1], 0.0)
            chosen_rp = jnp.take_along_axis(
                r_p, xi[:, None, None], axis=2
            )[:, :, 0]
            ots = jnp.where(alive[:, None], ots * chosen_rp, ots)
            ot = jnp.sum(ots, axis=-1)
            vta = row_a * da[:, None]
            vtb = row_b * db[:, None]
            phia = phia.at[:, i, :].add(vta)
            phib = phib.at[:, i, :].add(vtb)

            def sm(inv, u, vt, gii, dlt):
                # (S_p + u_p vt)^-1 per component (u [P, n], vt [w, n]).
                t1 = jnp.einsum("wpab,pb->wpa", inv, u)
                t2 = jnp.einsum("wa,wpab->wpb", vt, inv)
                denom = 1.0 + dlt[:, None] * gii
                return inv - (
                    t1[..., None] * t2[:, :, None, :]
                    / denom[:, :, None, None]
                )

            inva = sm(inva, tai, vta, ga, da)
            invb = sm(invb, tbi, vtb, gb, db)
            return (phia, phib, inva, invb, ots, ot, weight, dlog), xi

        dlog0 = jnp.zeros((nw,), cdtype)
        (phia, phib, _, _, _, _, weight, dlog), fields = jax.lax.scan(
            body,
            (state.phia, state.phib, inva, invb, ots, ot, state.weight,
             dlog0),
            (jnp.arange(m), rs),
        )
        return (
            state.replace(phia=phia, phib=phib, weight=weight,
                          log_ovlp=state.log_ovlp + dlog),
            fields.T,
        )

    def _boson_move_mc(self, trial, state, key, dt):
        """Drift-diffusion phonon move with the MIXTURE drift and bosonic
        local energy (``hubbard_holstein.py:314-356`` with the symmetrized
        trial's value/gradient, coherent_state.py:549-600)."""
        from pauxy_jax.models import multi_coherent as mc

        x = state.X
        grad_old, lap_old, _ = mc.mc_boson_mixture(
            trial, state.phia, state.phib, x
        )
        pot = lambda z: 0.5 * self.m * self.w0 ** 2 * jnp.sum(z * z, -1)
        eloc_old = (
            -0.5 * jnp.sum(lap_old, -1).real / self.m + pot(x)
            - 0.5 * self.w0 * x.shape[-1]
        )
        drift = (dt / self.m) * grad_old.real
        dx = jax.random.normal(key, x.shape, dtype=x.dtype) * jnp.sqrt(
            dt / self.m
        )
        x_new = x + dx + drift
        _, lap_new, _ = mc.mc_boson_mixture(
            trial, state.phia, state.phib, x_new
        )
        eloc_new = (
            -0.5 * jnp.sum(lap_new, -1).real / self.m + pot(x_new)
            - 0.5 * self.w0 * x.shape[-1]
        )
        log_new = mc.mc_log_overlap(trial, state.phia, state.phib, x_new)
        weight = state.weight * jnp.exp(
            -0.5 * dt * (eloc_new + eloc_old - 2 * self.eshift_boson)
        )
        # Reference scheme: walker.ot *= value_new/value_old at the boson
        # move (hubbard_holstein.py:355), so the NEXT electron overlap ratio
        # divides this move's trial-value ratio out of the weight. Storing
        # 2 log_new - log_old reproduces that deferred division exactly (the
        # following electron half-step resets log_ovlp to the absolute
        # mixture); a one-component mixture then matches the
        # single-coherent path trajectory-for-trajectory.
        log_carry = 2.0 * log_new - state.log_ovlp
        return state.replace(
            X=x_new,
            weight=weight,
            log_ovlp=log_carry.astype(state.log_ovlp.dtype),
        )

    def propagate(self, trial, state, key, eshift, bp_ix=None, ham=None):
        from pauxy_jax.models.multi_coherent import MultiCoherentTrial

        k1, k2, k3 = jax.random.split(key, 3)
        mc = isinstance(trial, MultiCoherentTrial)
        e_half = self._electron_half_step_mc if mc else self._electron_half_step
        sweep = self._site_sweep_mc if mc else (
            lambda t, s, k: self.hirsch._site_sweep(t, s, k))
        boson = self._boson_move_mc if mc else self._boson_move
        if self.symmetric_trotter:
            # boson(dt/2) K(dt/2) U(dt) K(dt/2) boson(dt/2)
            # (hubbard_holstein.py:419-429).
            state = boson(trial, state, k2, 0.5 * self.dt)
        state = e_half(trial, state, 0.5 * self.dt)
        state, _fields = sweep(trial, state, k1)
        state = e_half(trial, state, 0.5 * self.dt)
        if self.symmetric_trotter:
            state = boson(trial, state, k3, 0.5 * self.dt)
        else:
            state = boson(trial, state, k2, self.dt)
        growth = jnp.exp(self.dt * jnp.real(eshift))
        return state.replace(weight=state.weight * growth)


def make_hirsch_dmc(ham, trial, dt: float, lang_firsov: bool = False,
                    symmetric_trotter: bool = False,
                    precision=None) -> HirschDMC:
    """lang_firsov=True replaces U by the LF effective interaction in the
    Hirsch field tables (``propagation/hubbard_holstein.py:63-69``)."""
    prec = config.get_precision(precision)
    from pauxy_jax.utils.transfer import to_device, to_host

    ham_eff = ham
    if lang_firsov:
        from pauxy_jax.models.hubbard_holstein import _lf_params

        _gamma, ueff = _lf_params(ham)
        ham_eff = ham.replace(U=float(ueff))
    hirsch = make_hirsch(ham_eff, trial, dt)
    t = np.asarray(ham.T)
    bt_half = np.stack(
        [scipy.linalg.expm(-0.5 * dt * t[0]), scipy.linalg.expm(-0.5 * dt * t[1])]
    )
    if getattr(trial, "shift", None) is None:
        # The reference requires trial.shift too (it crashes with
        # AttributeError on trial.shift.copy(), hubbard_holstein.py:134,
        # for electron-only trials); fail with a clear message instead.
        raise ValueError(
            "Hubbard-Holstein discrete propagation needs a phonon-aware "
            "trial providing a coherent-state shift (coherent_state, "
            f"lang_firsov, or multi-coherent); got {type(trial).__name__}"
        )
    shift_host = np.asarray(to_host(trial.shift))
    eshift_b = float(
        np.asarray(
            hh.ho_local_energy(
                jnp.asarray(shift_host), ham.m, ham.w0, jnp.asarray(shift_host)
            )
        )
    )
    return HirschDMC(
        hirsch=hirsch,
        BT_half=to_device(bt_half.astype(prec.cplx)),
        dt=float(dt),
        m=float(ham.m),
        w0=float(ham.w0),
        cpl=float(ham.gsq2mw),
        eshift_boson=eshift_b,
        symmetric_trotter=bool(symmetric_trotter),
    )
