"""Discrete Hubbard-Stratonovich (Hirsch) propagation for the Hubbard model.

Batched counterpart of ``pauxy/propagation/hubbard.py:12-345`` (Hirsch).
The classic CPMC update is a *sequential* sweep over lattice sites — each
site's heat-bath probability uses the Green's function updated by every
previous flip — so it cannot be batched over sites. It CAN be batched over
walkers: here the sweep is one ``lax.scan`` over sites whose body does the
whole population's rank-1 algebra at once:

  per site i (vectors over the walker batch):
    G_ss(i,i)  from the maintained inverse overlaps        O(w n^2)
    heat-bath p(x) = 0.5 prod_s (1 + delta[x,s] G_ss(i,i)) * aux_wfac[x]
    phaseless choice, weight *= p(0)+p(1)                  (hubbard.py:172-220)
    rank-1 row update of phi + Sherman-Morrison of S^-1    O(w n^2)

The two kinetic half-steps bracket the sweep with the real-part/phase
constraint of ``kinetic_importance_sampling`` (hubbard.py:146-170). On a GPU
a real propagation runs the sweep as one Pallas kernel per walker block
instead (ops/sweep_triton.py).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.ops import clinalg
from pauxy_jax.walkers.state import WalkerState


@struct.dataclass
class Hirsch:
    """Discrete HS propagator (spin or charge decomposition).

    Tables (``hubbard.py:60-81``), with gamma = arccosh(e^{+/- dt U / 2}):
      spin:   auxf[x,s] = e^{+/- gamma} e^{-dt U/2},     aux_wfac = 1
      charge: auxf[x,s] = e^{+/- gamma} e^{-dt U/2},     aux_wfac = e^{dt U/2 -/+ gamma}
    """

    BT2: jax.Array        # [2, M, M] expm(-dt/2 T)  (note: T, not h1e_mod)
    auxf: jax.Array       # [2(field), 2(spin)] complex
    aux_wfac: jax.Array   # [2] complex
    dt: float = struct.field(pytree_node=False)
    free_projection: bool = struct.field(pytree_node=False, default=False)
    charge: bool = struct.field(pytree_node=False, default=False)
    # For interface parity with Continuous (driver eshift handling).
    hybrid: bool = struct.field(pytree_node=False, default=False)
    # gamma = arccosh(e^{+/- dt U/2}) for the dynamic-force-bias update.
    gamma: complex = struct.field(pytree_node=False, default=0.0)
    # 'single_site' (sequential sweep) or 'direct' (whole-lattice dynamic
    # force bias, hubbard.py:222-275).
    two_body_mode: str = struct.field(pytree_node=False, default="single_site")
    # Momentum-space kinetic application (hubbard.py:800-833); btk[ny, nx]
    # is exp(-dt/2 eps_k) on the FFT grid. None -> dense BT2 matmul.
    btk: jax.Array | None = None
    nx: int = struct.field(pytree_node=False, default=0)
    ny: int = struct.field(pytree_node=False, default=0)
    # Site-sweep implementation: 'scan' (lax.scan over sites) or 'triton'
    # (one Pallas kernel per walker block, ops/sweep_triton.py; only for a
    # real propagation on a GPU — see _choose_sweep_kernel). Tests ask for
    # 'triton_interpret' to run the kernel on the CPU.
    sweep_kernel: str = struct.field(pytree_node=False, default="scan")

    @property
    def delta(self):
        return self.auxf - 1.0

    # ------------------------------------------------------------------
    def _apply_bt2(self, phi):
        """B_{T/2} phi: dense matmul, or diagonal in momentum space when the
        lattice is a clean PBC torus (kinetic_kspace, hubbard.py:800-833)."""
        if self.btk is None:
            return None  # caller uses the per-spin dense path
        w, m, n = phi.shape
        g = phi.reshape(w, self.ny, self.nx, n)
        gk = jnp.fft.fft2(g, axes=(1, 2))
        gk = gk * self.btk[None, :, :, None]
        return jnp.fft.ifft2(gk, axes=(1, 2)).reshape(w, m, n)

    def _kinetic_half_step(self, trial, state: WalkerState) -> WalkerState:
        """B_{T/2} phi + real-part constraint (hubbard.py:146-170)."""
        if self.btk is not None:
            phia = self._apply_bt2(state.phia)
            phib = self._apply_bt2(state.phib)
        else:
            phia = jnp.einsum("pm,wmn->wpn", self.BT2[0], state.phia,
                              optimize=True)
            phib = jnp.einsum("pm,wmn->wpn", self.BT2[1], state.phib,
                              optimize=True)
        sa = jnp.einsum("wmi,mj->wij", phia, trial.psia.conj())
        sb = jnp.einsum("wmi,mj->wij", phib, trial.psib.conj())
        log_new = (clinalg.slogdet(sa) + clinalg.slogdet(sb)).astype(
            state.log_ovlp.dtype
        )
        log_ratio = log_new - state.log_ovlp
        ratio = jnp.exp(log_ratio)
        # |phase| < pi/2 -> keep Re(ratio); else kill (hubbard.py:160-170).
        phase_ok = jnp.abs(jnp.angle(ratio)) < 0.5 * jnp.pi
        weight = jnp.where(phase_ok, state.weight * ratio.real, 0.0)
        return state.replace(
            phia=phia, phib=phib, weight=weight, log_ovlp=log_new
        )

    # ------------------------------------------------------------------
    def _site_sweep(self, trial, state: WalkerState, key) -> WalkerState:
        """Sequential single-site updates, batched over walkers
        (hubbard.py:172-220)."""
        if self.sweep_kernel != "scan":
            return self._site_sweep_triton(trial, state, key)
        m = state.nbasis
        nw = state.nwalkers
        cdtype = state.phia.dtype
        rdtype = state.weight.dtype
        delta = self.delta

        # Maintained inverse overlaps S_s^-1 with S_s = psi_s^dag phi_s
        # (single_det.py:96-115).
        sa = jnp.einsum("mi,wmj->wij", trial.psia.conj(), state.phia)
        sb = jnp.einsum("mi,wmj->wij", trial.psib.conj(), state.phib)
        eye_a = jnp.broadcast_to(jnp.eye(sa.shape[-1], dtype=cdtype), sa.shape)
        eye_b = jnp.broadcast_to(jnp.eye(sb.shape[-1], dtype=cdtype), sb.shape)
        inva = clinalg.solve(sa, eye_a)
        invb = clinalg.solve(sb, eye_b)

        rs = jax.random.uniform(key, (m, nw), dtype=rdtype)

        def gii(inv, phi_row, psi_row):
            # G_ii = psi*[i] . (S^-T phi[i])  (hubbard.py:104-127).
            q = jnp.einsum("wba,wb->wa", inv, phi_row)
            return jnp.einsum("a,wa->w", psi_row.conj(), q)

        def sherman_morrison(inv, u, vt):
            # (S + u vt)^-1 update; u [n] trial row, vt [w, n].
            t1 = jnp.einsum("wab,b->wa", inv, u)
            t2 = jnp.einsum("wa,wab->wb", vt, inv)
            denom = 1.0 + jnp.einsum("wa,wa->w", vt, t1)
            return inv - t1[:, :, None] * t2[:, None, :] / denom[:, None, None]

        def body(carry, inputs):
            phia, phib, inva, invb, weight, dlog = carry
            i, r = inputs
            row_a = jnp.take(phia, i, axis=1)             # [w, na]
            row_b = jnp.take(phib, i, axis=1)
            ga = gii(inva, row_a, trial.psia[i])
            gb = gii(invb, row_b, trial.psib[i])
            # Heat-bath probabilities (hubbard.py:535-556 + aux_wfac).
            r1 = (1 + delta[0, 0] * ga) * (1 + delta[0, 1] * gb)
            r2 = (1 + delta[1, 0] * ga) * (1 + delta[1, 1] * gb)
            probs = 0.5 * jnp.stack([r1, r2], -1) * self.aux_wfac[None, :]
            pr = jnp.maximum(probs.real, 0.0)
            norm = pr.sum(-1)
            alive = (norm > 0) & (jnp.abs(weight) > 0)
            safe_norm = jnp.where(alive, norm, 1.0)
            xi = (r >= pr[:, 0] / safe_norm).astype(jnp.int32)  # [w]
            weight = jnp.where(alive, weight * norm, 0.0)
            chosen = jnp.take_along_axis(probs, xi[:, None], axis=1)[:, 0]
            dlog = dlog + jnp.where(
                alive, jnp.log(2.0 * chosen.astype(cdtype)), 0.0
            )
            da = jnp.where(alive, delta[xi, 0], 0.0)      # [w]
            db = jnp.where(alive, delta[xi, 1], 0.0)
            vt_a = row_a * da[:, None]
            vt_b = row_b * db[:, None]
            phia = phia.at[:, i, :].add(vt_a)
            phib = phib.at[:, i, :].add(vt_b)
            inva = sherman_morrison(inva, trial.psia[i].conj(), vt_a)
            invb = sherman_morrison(invb, trial.psib[i].conj(), vt_b)
            return (phia, phib, inva, invb, weight, dlog), xi

        dlog0 = jnp.zeros((nw,), cdtype)
        (phia, phib, _, _, weight, dlog), fields = jax.lax.scan(
            body,
            (state.phia, state.phib, inva, invb, state.weight, dlog0),
            (jnp.arange(m), rs),
        )
        return (
            state.replace(
                phia=phia,
                phib=phib,
                weight=weight,
                log_ovlp=state.log_ovlp + dlog,
            ),
            fields.T,  # [w, M] chosen field per site
        )

    def _site_sweep_triton(self, trial, state: WalkerState, key):
        """Same sweep as one Pallas kernel per walker block
        (ops/sweep_triton.py), for the all-real case only."""
        from pauxy_jax.ops import sweep_triton

        m = state.nbasis
        nw = state.nwalkers
        cdtype = state.phia.dtype
        rdtype = state.weight.dtype
        psia = trial.psia.real.astype(rdtype)
        psib = trial.psib.real.astype(rdtype)
        phia = state.phia.real.astype(rdtype)
        phib = state.phib.real.astype(rdtype)
        sa = jnp.einsum("mi,wmj->wij", psia, phia)
        sb = jnp.einsum("mi,wmj->wij", psib, phib)
        # Identical draw to the scan path -> identical trajectories.
        rs = jax.random.uniform(key, (m, nw), dtype=rdtype)
        phia, phib, weight, dlog, fields = sweep_triton.hirsch_sweep_real(
            psia, psib, self.delta.real.astype(rdtype),
            self.aux_wfac.real.astype(rdtype), phia, phib,
            jnp.linalg.inv(sa), jnp.linalg.inv(sb), rs, state.weight,
            interpret=self.sweep_kernel == "triton_interpret",
        )
        return (
            state.replace(
                phia=phia.astype(cdtype),
                phib=phib.astype(cdtype),
                weight=weight,
                log_ovlp=state.log_ovlp + dlog.astype(cdtype),
            ),
            fields,
        )

    # ------------------------------------------------------------------
    def _two_body_direct(self, trial, state: WalkerState, key):
        """Whole-lattice discrete update with dynamic force bias from the
        current G diagonal (PRA 92, 033603; hubbard.py:222-275). Unlike the
        site sweep this is embarrassingly parallel over sites — one shot of
        field sampling + a diagonal scaling — at the cost of a weaker
        importance function."""
        m = state.nbasis
        nw = state.nwalkers
        cdtype = state.phia.dtype
        rdtype = state.weight.dtype
        gamma = jnp.asarray(self.gamma, cdtype)

        sa = jnp.einsum("mi,wmj->wij", trial.psia.conj(), state.phia)
        sb = jnp.einsum("mi,wmj->wij", trial.psib.conj(), state.phib)
        inva = clinalg.solve(sa, jnp.broadcast_to(
            jnp.eye(sa.shape[-1], dtype=cdtype), sa.shape))
        invb = clinalg.solve(sb, jnp.broadcast_to(
            jnp.eye(sb.shape[-1], dtype=cdtype), sb.shape))
        # G_ii = sum_a psi*[i,a] (S^-T phi[i])_a per site (hubbard.py:240).
        nia = jnp.einsum("ia,wba,wib->wi", trial.psia.conj(), inva, state.phia)
        nib = jnp.einsum("ia,wba,wib->wi", trial.psib.conj(), invb, state.phib)
        fb_term = (nia + nib - 1.0) if self.charge else (nia - nib)

        pp = 0.5 * jnp.exp(gamma * fb_term).real           # [w, M]
        pm = 0.5 * jnp.exp(-gamma * fb_term).real
        norm = pp + pm
        r = jax.random.uniform(key, (nw, m), dtype=rdtype)
        xi = (r >= pp / norm).astype(jnp.int32)
        sign = jnp.where(xi == 0, -1.0, 1.0).astype(cdtype)
        fb_fac = jnp.prod(
            (0.5 * norm) * jnp.exp(sign * gamma * fb_term).real, axis=-1
        )

        ga = self.auxf[xi, 0]                              # [w, M]
        gb = self.auxf[xi, 1]
        phia = state.phia * ga[:, :, None]
        phib = state.phib * gb[:, :, None]
        wfac = jnp.prod(self.aux_wfac[xi], axis=-1)

        sa = jnp.einsum("wmi,mj->wij", phia, trial.psia.conj())
        sb = jnp.einsum("wmi,mj->wij", phib, trial.psib.conj())
        log_new = (clinalg.slogdet(sa) + clinalg.slogdet(sb)).astype(
            state.log_ovlp.dtype
        )
        ratio = wfac * jnp.exp(log_new - state.log_ovlp)
        phase_ok = jnp.abs(jnp.angle(ratio)) < 0.5 * jnp.pi
        weight = jnp.where(
            phase_ok, state.weight * (fb_fac * ratio).real, 0.0
        )
        return (
            state.replace(phia=phia, phib=phib, weight=weight,
                          log_ovlp=log_new),
            xi,
        )

    # ------------------------------------------------------------------
    def _propagate_constrained(self, trial, state, key, eshift, bp_ix=None):
        """kinetic half, site sweep, kinetic half, eshift factor
        (hubbard.py:276-301)."""
        state = self._kinetic_half_step(trial, state)
        if self.two_body_mode == "direct":
            state, fields = self._two_body_direct(trial, state, key)
        else:
            state, fields = self._site_sweep(trial, state, key)
        state = self._kinetic_half_step(trial, state)
        growth = jnp.exp(self.dt * jnp.real(eshift))
        state = state.replace(weight=state.weight * growth)
        if state.configs is not None and bp_ix is not None:
            # Store integer field choices for BP (stack.py:34-49 push).
            state = state.replace(
                configs=state.configs.at[:, bp_ix, :].set(
                    fields.astype(state.configs.dtype)
                )
            )
        return state

    def _propagate_free(self, trial, state, key, eshift):
        """Free projection: fields 50/50, |wfac| to weight, phase to phase
        (hubbard.py:303-344)."""
        phia = jnp.einsum("pm,wmn->wpn", self.BT2[0], state.phia, optimize=True)
        phib = jnp.einsum("pm,wmn->wpn", self.BT2[1], state.phib, optimize=True)
        xi = jax.random.bernoulli(key, 0.5, (state.nwalkers, state.nbasis)).astype(
            jnp.int32
        )
        ga = self.auxf[xi, 0]                             # [w, M]
        gb = self.auxf[xi, 1]
        phia = phia * ga[:, :, None]
        phib = phib * gb[:, :, None]
        phia = jnp.einsum("pm,wmn->wpn", self.BT2[0], phia, optimize=True)
        phib = jnp.einsum("pm,wmn->wpn", self.BT2[1], phib, optimize=True)
        wfac = jnp.prod(self.aux_wfac[xi], axis=-1)
        sa = jnp.einsum("wmi,mj->wij", phia, trial.psia.conj())
        sb = jnp.einsum("wmi,mj->wij", phib, trial.psib.conj())
        log_new = (clinalg.slogdet(sa) + clinalg.slogdet(sb)).astype(
            state.log_ovlp.dtype
        )
        growth = jnp.exp(self.dt * jnp.real(eshift))
        return state.replace(
            phia=phia,
            phib=phib,
            weight=state.weight * jnp.abs(wfac) * growth,
            phase=state.phase * jnp.exp(1j * jnp.angle(wfac)).astype(state.phase.dtype),
            log_ovlp=log_new,
        )

    # ------------------------------------------------------------------
    # GHF (multi-determinant 2M x ne trial) variants. The walker stays
    # block-diagonal (models/ghf.py docstring); per-site ratios follow
    # ``pauxy/propagation/hubbard.py:483-510`` and the inverse-overlap
    # algebra ``pauxy/walkers/multi_ghf.py:85-117``.
    # ------------------------------------------------------------------
    def _kinetic_half_step_ghf(self, trial, state):
        from pauxy_jax.models.ghf import ghf_log_overlap

        phia = jnp.einsum("pm,wmn->wpn", self.BT2[0], state.phia, optimize=True)
        phib = jnp.einsum("pm,wmn->wpn", self.BT2[1], state.phib, optimize=True)
        log_new = ghf_log_overlap(trial, phia, phib).astype(state.log_ovlp.dtype)
        ratio = jnp.exp(log_new - state.log_ovlp)
        phase_ok = jnp.abs(jnp.angle(ratio)) < 0.5 * jnp.pi
        weight = jnp.where(phase_ok, state.weight * ratio.real, 0.0)
        return state.replace(phia=phia, phib=phib, weight=weight,
                             log_ovlp=log_new)

    def _site_sweep_ghf(self, trial, state, key):
        """Sequential single-site updates against a multi-det GHF trial,
        batched over walkers AND determinants."""
        from pauxy_jax.models.ghf import ghf_overlap_matrices
        from pauxy_jax.ops import clinalg as _cl

        m = state.nbasis
        nw = state.nwalkers
        na = trial.nup
        cdtype = state.phia.dtype
        rdtype = state.weight.dtype
        delta = self.delta
        cconj = trial.coeffs.conj()                       # [D]
        tpsi = trial.psi.conj()                           # [D, 2M, ne]

        s = ghf_overlap_matrices(trial, state.phia, state.phib)
        ne = s.shape[-1]
        eye = jnp.broadcast_to(jnp.eye(ne, dtype=cdtype), s.shape)
        binv = _cl.solve(s, eye)                          # [w, D, ne, ne]
        logdets = _cl.slogdet(s)                          # [w, D]
        ref = jnp.max(logdets.real, axis=-1, keepdims=True)
        ots = jnp.exp(logdets - ref)                      # scale-free dets
        ot = jnp.einsum("d,wd->w", cconj, ots)

        rs = jax.random.uniform(key, (m, nw), dtype=rdtype)

        def body(carry, inputs):
            phia, phib, binv, ots, ot, weight, dlog = carry
            i, r = inputs
            row_a = jnp.take(phia, i, axis=1)             # [w, na]
            row_b = jnp.take(phib, i, axis=1)             # [w, nb]
            tup = jnp.take(tpsi, i, axis=1)               # [D, ne] conj'd
            tdn = jnp.take(tpsi, i + m, axis=1)
            u_a = jnp.einsum("we,wdek->wdk", row_a, binv[:, :, :na, :])
            u_b = jnp.einsum("we,wdek->wdk", row_b, binv[:, :, na:, :])
            guu = jnp.einsum("wdk,dk->wd", u_a, tup)
            gdu = jnp.einsum("wdk,dk->wd", u_a, tdn)
            gud = jnp.einsum("wdk,dk->wd", u_b, tup)
            gdd = jnp.einsum("wdk,dk->wd", u_b, tdn)
            # Joint two-row det ratio per det per field (hubbard.py:498-508).
            r_d = (
                (1 + delta[:, 0][None, None] * guu[..., None])
                * (1 + delta[:, 1][None, None] * gdd[..., None])
                - delta[:, 0][None, None] * delta[:, 1][None, None]
                * (gud * gdu)[..., None]
            )                                             # [w, D, 2]
            rtot = jnp.einsum("d,wdx,wd->wx", cconj, r_d, ots) / ot[:, None]
            probs = 0.5 * rtot * self.aux_wfac[None, :]
            pr = jnp.maximum(probs.real, 0.0)
            norm = pr.sum(-1)
            alive = (norm > 0) & (jnp.abs(weight) > 0)
            safe_norm = jnp.where(alive, norm, 1.0)
            xi = (r >= pr[:, 0] / safe_norm).astype(jnp.int32)
            weight = jnp.where(alive, weight * norm, 0.0)
            chosen_rtot = jnp.take_along_axis(rtot, xi[:, None], axis=1)[:, 0]
            dlog = dlog + jnp.where(
                alive, jnp.log(chosen_rtot.astype(cdtype)), 0.0
            )
            da = jnp.where(alive, delta[xi, 0], 0.0)      # [w]
            db = jnp.where(alive, delta[xi, 1], 0.0)
            chosen_rd = jnp.take_along_axis(
                r_d, xi[:, None, None], axis=2
            )[:, :, 0]                                    # [w, D]
            ots = jnp.where(alive[:, None], ots * chosen_rd, ots)
            ot = jnp.einsum("d,wd->w", cconj, ots)
            # Rank-1 row updates of phi.
            vta = row_a * da[:, None]
            vtb = row_b * db[:, None]
            phia = phia.at[:, i, :].add(vta)
            phib = phib.at[:, i, :].add(vtb)
            # Sequential Sherman-Morrison: S += tup (x) [vta, 0], then
            # S += tdn (x) [0, vtb] — the second uses the updated inverse.
            bu = jnp.einsum("wdek,dk->wde", binv, tup)
            denom1 = 1.0 + da[:, None] * guu
            binv = binv - (
                bu[..., None] * (da[:, None, None] * u_a)[:, :, None, :]
                / denom1[:, :, None, None]
            )
            u_b2 = jnp.einsum("we,wdek->wdk", row_b, binv[:, :, na:, :])
            gdd2 = jnp.einsum("wdk,dk->wd", u_b2, tdn)
            bu2 = jnp.einsum("wdek,dk->wde", binv, tdn)
            denom2 = 1.0 + db[:, None] * gdd2
            binv = binv - (
                bu2[..., None] * (db[:, None, None] * u_b2)[:, :, None, :]
                / denom2[:, :, None, None]
            )
            return (phia, phib, binv, ots, ot, weight, dlog), xi

        dlog0 = jnp.zeros((nw,), cdtype)
        (phia, phib, _, _, _, weight, dlog), fields = jax.lax.scan(
            body,
            (state.phia, state.phib, binv, ots, ot, state.weight, dlog0),
            (jnp.arange(m), rs),
        )
        return (
            state.replace(
                phia=phia, phib=phib, weight=weight,
                log_ovlp=state.log_ovlp + dlog,
            ),
            fields.T,
        )

    def _propagate_ghf(self, trial, state, key, eshift, bp_ix=None):
        state = self._kinetic_half_step_ghf(trial, state)
        state, fields = self._site_sweep_ghf(trial, state, key)
        state = self._kinetic_half_step_ghf(trial, state)
        growth = jnp.exp(self.dt * jnp.real(eshift))
        state = state.replace(weight=state.weight * growth)
        if state.configs is not None and bp_ix is not None:
            state = state.replace(
                configs=state.configs.at[:, bp_ix, :].set(
                    fields.astype(state.configs.dtype)
                )
            )
        return state

    def propagate(self, trial, state, key, eshift, bp_ix=None, ham=None):
        from pauxy_jax.models.ghf import GHFTrial

        if isinstance(trial, GHFTrial):
            return self._propagate_ghf(trial, state, key, eshift, bp_ix)
        if self.free_projection:
            return self._propagate_free(trial, state, key, eshift)
        return self._propagate_constrained(trial, state, key, eshift, bp_ix)


def make_hirsch(
    ham,
    trial,
    dt: float,
    charge_decomposition: bool = False,
    free_projection: bool = False,
    precision=None,
    two_body_mode: str = "single_site",
    kinetic_kspace: bool = False,
    sweep_kernel: str | None = None,
) -> Hirsch:
    """Build the discrete propagator tables (hubbard.py:30-103).

    ``two_body_mode='direct'`` selects the whole-lattice dynamic-force-bias
    update (hubbard.py:222); ``kinetic_kspace`` applies B_{T/2} as a
    diagonal in momentum space (hubbard.py:800-833) — valid only for a
    clean PBC lattice (no twist/pinning; T must be circulant)."""
    prec = config.get_precision(precision)
    t = np.asarray(ham.T)
    bt2 = np.stack(
        [scipy.linalg.expm(-0.5 * dt * t[0]), scipy.linalg.expm(-0.5 * dt * t[1])]
    )
    btk = None
    nx = ny = 0
    if kinetic_kspace:
        nx, ny = int(ham.nx), int(ham.ny)
        # T circulant on the (ny, nx) torus: its DFT eigenvalues are the
        # FFT2 of the stencil column centred at site 0, eps_k = FFT2(T[:,0]).
        c = t[0][:, 0].reshape(ny, nx)
        ek = np.fft.fft2(c)
        if np.abs(ek.imag).max() > 1e-10:
            raise ValueError(
                "kinetic_kspace requires a circulant hopping matrix "
                "(PBC, no twist/pinning)"
            )
        btk_mat = np.exp(-0.5 * dt * ek.real)
        # Validate the diagonalization against the dense exponential.
        f = np.fft.fft2(np.eye(nx * ny).reshape(nx * ny, ny, nx),
                        axes=(1, 2)).reshape(nx * ny, nx * ny)
        recon = (f.conj().T @ (btk_mat.reshape(-1)[:, None] * f) / (nx * ny))
        assert np.abs(recon - bt2[0]).max() < 1e-8
        btk = btk_mat
    if charge_decomposition:
        gamma = np.arccosh(np.exp(-0.5 * dt * ham.U + 0j))
        auxf = np.array(
            [
                [np.exp(gamma), np.exp(gamma)],
                [np.exp(-gamma), np.exp(-gamma)],
            ]
        )
        aux_wfac = np.exp(0.5 * dt * ham.U) * np.array(
            [np.exp(-gamma), np.exp(gamma)]
        )
    else:
        if ham.U < 0:
            # arccosh(e^{dt U/2}) is complex for attractive U: the SPIN HS
            # decomposition only exists for repulsive interactions (the
            # reference silently NaNs here, hubbard.py:63).
            raise ValueError(
                "discrete spin decomposition requires U >= 0; use "
                "propagator {'charge_decomposition': true} for attractive U"
            )
        gamma = np.arccosh(np.exp(0.5 * dt * ham.U))
        auxf = np.array(
            [
                [np.exp(gamma), np.exp(-gamma)],
                [np.exp(-gamma), np.exp(gamma)],
            ]
        )
        aux_wfac = np.array([1.0, 1.0])
    auxf = auxf * np.exp(-0.5 * dt * ham.U)
    from pauxy_jax.utils.transfer import to_device

    if sweep_kernel is None:
        sweep_kernel = _choose_sweep_kernel(
            trial, t, auxf, aux_wfac, free_projection, two_body_mode)
    return Hirsch(
        BT2=to_device(bt2.astype(prec.cplx)),
        auxf=to_device(np.asarray(auxf).astype(prec.cplx)),
        aux_wfac=to_device(np.asarray(aux_wfac).astype(prec.cplx)),
        dt=float(dt),
        free_projection=bool(free_projection),
        charge=bool(charge_decomposition),
        gamma=complex(gamma),
        two_body_mode=str(two_body_mode),
        btk=(to_device(btk.astype(prec.cplx)) if btk is not None else None),
        nx=nx,
        ny=ny,
        sweep_kernel=sweep_kernel,
    )


def _choose_sweep_kernel(trial, t, auxf, aux_wfac, free_projection,
                         two_body_mode) -> str:
    """'triton' on a GPU whenever the whole propagation is provably real —
    spin decomposition (real tables), real hopping, real single-det trial
    with both spins occupied — else 'scan'."""
    if jax.default_backend() != "gpu":
        return "scan"
    if free_projection or two_body_mode != "single_site":
        return "scan"
    if any(np.abs(np.asarray(x).imag).max() > 0 for x in (auxf, aux_wfac, t)):
        return "scan"   # charge/attractive tables or a twisted lattice
    from pauxy_jax.utils.transfer import to_host

    psi = [np.asarray(to_host(getattr(trial, k, None)))
           for k in ("psia", "psib", "inita", "initb")]
    if any(p.ndim != 2 or p.shape[1] == 0 for p in psi):
        return "scan"   # multi-det trials, fully spin-polarized systems
    if any(np.iscomplexobj(p) and np.abs(p.imag).max() > 0 for p in psi):
        return "scan"
    return "triton"
