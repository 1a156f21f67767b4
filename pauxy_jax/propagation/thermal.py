"""Finite-temperature continuous-HS propagation.

Batched counterpart of ``pauxy/thermal_propagation/continuous.py:14-260``
plus the thermal inner propagators (``thermal_propagation/generic.py:11-167``,
``hubbard.py:182-250``, ``planewave.py:15-178``). Per slice:

    B(x) = B_{H1/2} e^{VHS(x - xbar)} B_{H1/2}

with the force bias evaluated on the walker's 1-RDM P = 1 - G^T, the slice
pushed into the binned stack, the Green's function re-stratified, and the
phaseless weight from the determinant ratio

    det G_old / det G_new = det(1 + A_new) / det(1 + A_old).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.linalg
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config
from pauxy_jax.estimators.thermal import one_rdm_from_G
from pauxy_jax.walkers import low_rank as lrw
from pauxy_jax.walkers import thermal_state as tws


def clamp_force_bias(xbar, bound: float):
    """Rescale components with |xbar| > bound to UNIT magnitude — not to
    ``bound`` — exactly like the reference's fb_bound handling
    (``thermal_propagation/planewave.py:249-261``)."""
    absx = jnp.abs(xbar)
    return jnp.where(
        absx > bound, xbar / jnp.where(absx == 0, 1.0, absx), xbar
    )


@struct.dataclass
class ThermalHubbardInner:
    """Charge-decomposition HS for Hubbard at T > 0
    (thermal_propagation/hubbard.py:182-250)."""

    BH1: jax.Array        # [2, M, M] includes mean-field shift and mu
    mf_shift: jax.Array   # [M]
    dt: float = struct.field(pytree_node=False)
    U: float = struct.field(pytree_node=False)

    def force_bias_P(self, p):
        d = jnp.diagonal(p, axis1=-2, axis2=-1)           # [w, 2, M]
        vbias = 1j * self.U ** 0.5 * (d[:, 0] + d[:, 1])
        return -(self.dt ** 0.5) * (vbias - self.mf_shift)

    def dense_bv(self, xshifted):
        gauge = jnp.exp(self.dt ** 0.5 * 1j * self.U ** 0.5 * xshifted)
        m = gauge.shape[-1]
        eye = jnp.eye(m, dtype=gauge.dtype)
        bv = eye[None] * gauge[:, :, None]                # diag per walker
        return jnp.stack([bv, bv], axis=1)                # [w, 2, M, M]


@struct.dataclass
class ThermalGenericInner:
    """Cholesky Hamiltonian at T > 0 (thermal_propagation/generic.py)."""

    BH1: jax.Array
    mf_shift: jax.Array   # [X]
    chol: jax.Array       # [M, M, X]
    dt: float = struct.field(pytree_node=False)
    exp_order: int = struct.field(pytree_node=False, default=6)

    def force_bias_P(self, p):
        vbias = jnp.einsum(
            "pqx,wpq->wx", self.chol, p[:, 0] + p[:, 1], optimize=True
        )
        return -(self.dt ** 0.5) * (1j * vbias - self.mf_shift)

    def dense_bv(self, xshifted):
        from pauxy_jax.propagation.generic import apply_exponential_taylor

        m = self.chol.shape[0]
        vhs = (1j * self.dt ** 0.5) * jnp.einsum(
            "pqx,wx->wpq", self.chol, xshifted, optimize=True
        )
        eye = jnp.broadcast_to(
            jnp.eye(m, dtype=vhs.dtype), vhs.shape
        )
        bv = apply_exponential_taylor(vhs, eye, self.exp_order)
        return jnp.stack([bv, bv], axis=1)


@struct.dataclass
class ThermalUEGInner:
    """UEG at T > 0 (thermal_propagation/planewave.py full-rank path)."""

    BH1: jax.Array
    mf_shift: jax.Array   # [2 nq] zeros
    sp: Any               # ops/ueg_sparse.SparseRho
    dt: float = struct.field(pytree_node=False)
    exp_order: int = struct.field(pytree_node=False, default=6)

    @property
    def nq(self):
        return self.sp.nq

    def force_bias_P(self, p):
        from pauxy_jax.ops import ueg_sparse

        psum = p[:, 0] + p[:, 1]
        t1, t2 = ueg_sparse.rho_expectations(self.sp, psum)
        vplus = 1j * (t1 + t2)
        vminus = -(t1 - t2)
        return -(self.dt ** 0.5) * jnp.concatenate([vplus, vminus], axis=-1)

    def dense_bv(self, xshifted):
        from pauxy_jax.ops import ueg_sparse
        from pauxy_jax.propagation.generic import apply_exponential_taylor

        xa = xshifted[:, : self.nq]
        xb = xshifted[:, self.nq :]
        vhs = self.dt ** 0.5 * ueg_sparse.assemble_vhs(
            self.sp, 1j * xa - xb, 1j * xa + xb
        )
        m = vhs.shape[-1]
        eye = jnp.broadcast_to(jnp.eye(m, dtype=vhs.dtype), vhs.shape)
        bv = apply_exponential_taylor(vhs, eye, self.exp_order)
        return jnp.stack([bv, bv], axis=1)


@struct.dataclass
class ThermalContinuous:
    inner: Any
    dt: float = struct.field(pytree_node=False)
    mf_const_fac: complex = struct.field(pytree_node=False, default=1.0 + 0j)
    force_bias: bool = struct.field(pytree_node=False, default=True)
    # Force-bias clamp |xbar| <= fb_bound (thermal_propagation/planewave.py:30
    # 'fb_bound' option, default 1.0).
    fb_bound: float = struct.field(pytree_node=False, default=1.0)
    free_projection: bool = struct.field(pytree_node=False, default=False)
    low_rank: bool = struct.field(pytree_node=False, default=False)
    low_rank_thresh: float = struct.field(pytree_node=False, default=1e-6)

    def _sample_b(self, state, key, cdtype):
        """Sample auxiliary fields and build the slice propagator
        B = B_{H1/2} e^{VHS} B_{H1/2}; returns (b, cfb, cmf)
        (thermal_propagation/continuous.py:84-120 + planewave.py:220-274)."""
        inner = self.inner
        nw = state.nwalkers
        nfields = inner.mf_shift.shape[0]
        rdtype = state.weight.dtype
        sqrt_dt = self.dt ** 0.5

        xi = jax.random.normal(key, (nw, nfields), dtype=rdtype)
        if self.force_bias:
            p = one_rdm_from_G(state.G)
            xbar = inner.force_bias_P(p)
            xbar = clamp_force_bias(xbar, self.fb_bound)
        else:
            xbar = jnp.zeros((nw, nfields), cdtype)
        xshifted = xi - xbar
        cfb = jnp.sum(xi * xbar, -1) - 0.5 * jnp.sum(xbar * xbar, -1)
        cmf = -sqrt_dt * xshifted @ inner.mf_shift

        bv = inner.dense_bv(xshifted)                     # [w, 2, M, M]
        b = jnp.einsum("spm,wsmq,sqn->wspn", inner.BH1, bv, inner.BH1,
                       optimize=True)
        return b, cfb, cmf

    def _update_weight(self, state, log_oratio, cfb, cmf, extra):
        """Hybrid phaseless / free-projection weight update shared by the
        full-rank and low-rank paths (continuous.py:176-257)."""
        cdtype = log_oratio.dtype
        if self.free_projection:
            arg = cmf + cfb + log_oratio
            magn = jnp.exp(arg.real)
            weight = state.weight * magn
            phase = state.phase * jnp.exp(1j * arg.imag).astype(cdtype)
            weight = jnp.where(jnp.isfinite(weight), weight, 0.0)
            return state.replace(weight=weight, phase=phase, **extra)
        hybrid = log_oratio + cfb + cmf
        mfc = jnp.asarray(self.mf_const_fac, cdtype)
        magn = jnp.abs(mfc) * jnp.exp(hybrid.real)
        dtheta = (hybrid - cfb).imag
        cosine_fac = jnp.maximum(0.0, jnp.cos(dtheta))
        weight = state.weight * magn * cosine_fac
        weight = jnp.where(jnp.isfinite(weight), weight, 0.0)
        if state.hybrid_energy is not None:
            # Per-slice hybrid energy -(log oratio + cfb + cmf)/dt; computed
            # but never stored by the reference (continuous.py:241).
            extra = dict(extra, hybrid_energy=-hybrid / self.dt)
        return state.replace(weight=weight, **extra)

    def propagate_low_rank(self, trial, state, key, ts):
        """One time slice on the low-rank stack
        (thermal_propagation/planewave.py:519-573): the Green's function and
        det(1+A) come straight from the masked QDT update, and the weight
        uses the overlap ratio instead of det(G)/det(G')."""
        cdtype = state.log_ovlp.dtype
        b, cfb, cmf = self._sample_b(state, key, cdtype)
        btinv_diag = jnp.diagonal(trial.dmat_inv, axis1=-2, axis2=-1)
        new = lrw.update_low_rank(
            btinv_diag, state, b, ts,
            stack_size=trial.stack_size, thresh=self.low_rank_thresh,
        )
        log_oratio = jnp.sum(new.log_ovlp - state.log_ovlp, axis=-1)
        return self._update_weight(new, log_oratio, cfb, cmf, {})

    def propagate(self, trial, state, key, ts):
        """One time slice for the whole population
        (thermal_propagation/continuous.py:202-257)."""
        if isinstance(state, lrw.LowRankWalkerState):
            return self.propagate_low_rank(trial, state, key, ts)
        from pauxy_jax.estimators import thermal as th

        cdtype = state.log_m0.dtype
        b, cfb, cmf = self._sample_b(state, key, cdtype)

        state = tws.update_stack(trial, state, b, ts)
        extra = {}
        if state.pq is None:
            # Legacy state (e.g. restored from an old checkpoint): full
            # re-stratification over all bins every slice.
            g_new, log_m0_new = tws.greens_function(state.stack)
        else:
            # Prefix-cached re-stratification: bins below the active one
            # are final for the rest of this beta sweep, so their QDT fold
            # is refreshed once per bin entry and each slice only folds
            # bins block..nbins-1 on top of it — (nbins+1)/2 average cpqr
            # folds per slice instead of nbins, same numbers (the fold
            # sequence is identical, merely cached).
            ss = trial.stack_size
            block = ts // ss
            counter = ts % ss
            s = jnp.swapaxes(state.stack, 1, 2)           # [w, 2, bins, M, M]
            prefix = jax.lax.cond(
                (counter == 0) & (block > 0),
                lambda p: th.qdt_fold(s, p, block - 1, block),
                lambda p: p,
                (state.pq, state.pd, state.pt),
            )
            q, d, t = th.qdt_fold(s, prefix, block, state.nbins)
            g_new, log_m0_new = th.inverse_one_plus_qdt_logdet(q, d, t)
            extra = {"pq": prefix[0], "pd": prefix[1], "pt": prefix[2]}

        log_oratio = jnp.sum(state.log_m0 - log_m0_new, axis=-1)
        return self._update_weight(
            state, log_oratio, cfb, cmf,
            {"G": g_new, "log_m0": log_m0_new, **extra},
        )


def make_thermal_propagator(
    ham, trial, dt: float, options=None, precision=None
) -> ThermalContinuous:
    """Build the thermal propagator for any supported Hamiltonian."""
    prec = config.get_precision(precision)
    opts = dict(options or {})
    from pauxy_jax.utils.transfer import to_device, device_zeros

    p_trial = np.asarray(trial.P_host.arr)
    # The sampled slices B(x) carry the SYSTEM chemical potential (the grand-
    # canonical ensemble being simulated), which may differ from the trial's
    # bisected mu used in the unfilled B_T slices (thermal_propagation/
    # planewave.py:104-106 uses system.mu; generic.py:71).
    mu = opts.get("mu")
    if mu is None:
        mu = trial.mu
    mu = float(mu)
    name = ham.name
    if name == "Hubbard":
        iu = 1j * ham.U ** 0.5
        mf_shift = iu * (np.diagonal(p_trial[0]) + np.diagonal(p_trial[1]))
        h1 = (
            np.asarray(ham.h1e_mod)
            - iu * np.diag(mf_shift)[None]
            - mu * np.eye(ham.nbasis)[None]
        )
        bh1 = np.stack(
            [scipy.linalg.expm(-0.5 * dt * h1[0]),
             scipy.linalg.expm(-0.5 * dt * h1[1])]
        )
        inner = ThermalHubbardInner(
            BH1=to_device(bh1.astype(prec.cplx)),
            mf_shift=to_device(mf_shift.astype(prec.cplx)),
            dt=float(dt),
            U=float(ham.U),
        )
        mf_core = 0.5 * np.dot(mf_shift, mf_shift)
    elif name == "Generic":
        chol = np.asarray(ham.chol)
        mf_shift = 1j * np.einsum(
            "pqx,pq->x", chol, p_trial[0] + p_trial[1], optimize=True
        )
        shift = 1j * np.einsum("pqx,x->pq", chol, mf_shift, optimize=True)
        h1 = (
            np.asarray(ham.h1e_mod)
            - shift[None]
            - mu * np.eye(ham.nbasis)[None]
        )
        bh1 = np.stack(
            [scipy.linalg.expm(-0.5 * dt * h1[0]),
             scipy.linalg.expm(-0.5 * dt * h1[1])]
        )
        inner = ThermalGenericInner(
            BH1=to_device(bh1.astype(prec.cplx)),
            mf_shift=to_device(mf_shift.astype(prec.cplx)),
            chol=to_device(chol.astype(prec.cplx)),
            dt=float(dt),
        )
        mf_core = ham.ecore + 0.5 * np.dot(mf_shift, mf_shift)
    elif name == "UEG":
        h1 = np.asarray(ham.h1e_mod) - mu * np.eye(ham.nbasis)[None]
        bh1 = np.stack(
            [np.diag(np.exp(-0.5 * dt * np.diagonal(h1[0]))),
             np.diag(np.exp(-0.5 * dt * np.diagonal(h1[1])))]
        )
        from pauxy_jax.ops import ueg_sparse

        inner = ThermalUEGInner(
            BH1=to_device(bh1.astype(prec.cplx)),
            mf_shift=device_zeros((2 * ham.nq,), prec.cplx),
            sp=ueg_sparse.make_sparse_rho(ham, prec.real),
            dt=float(dt),
        )
        mf_core = 0.0
    else:
        raise NotImplementedError(f"no thermal propagator for {name!r}")
    return ThermalContinuous(
        inner=inner,
        dt=float(dt),
        mf_const_fac=complex(np.exp(-dt * complex(mf_core))),
        force_bias=opts.get("force_bias", True),
        fb_bound=float(opts.get("fb_bound", 1.0)),
        free_projection=opts.get("free_projection", False),
        low_rank=opts.get("low_rank", False),
        low_rank_thresh=float(opts.get("low_rank_thresh", 1e-6)),
    )
