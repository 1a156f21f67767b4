"""Walker-last fused block for Hubbard-class models (the headline path).

The generic block program keeps walker arrays as [w, M, n] and calls
batched small-matrix factorizations (solve/slogdet/QR) per walker. This
module runs the ENTIRE block in the transposed walker-last layout
[M, n, W] using ops/lanelinalg: one layout conversion per block, all
small-matrix factorizations unrolled into elementwise chains over the
walker axis. Physics is identical
to qmc/afqmc.run_block for the supported subset — same step schedule
(afqmc.py:223-255), same RNG consumption, same accumulator layout — and a
trajectory-parity test enforces it (tests/test_hubbard_fast.py).

Supported: Hubbard continuous HS (charge or spin decomposition,
single-determinant trial, hybrid phaseless, with/without force bias),
comb/pair_branch population control, mixed estimator. BP/ITCF/free
projection/RDM output fall back to the generic block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pauxy_jax.ops import lanelinalg as ll
from pauxy_jax.walkers import pop_control as pc


def eligible(ham, trial, prop, *, free_projection, nbp, nitcf,
             calc_one_rdm, calc_two_rdm, pop_method) -> bool:
    """Whether the lanes fast path reproduces the generic block exactly."""
    from pauxy_jax.propagation.continuous import Continuous
    from pauxy_jax.propagation.hubbard import HubbardContinuous

    return (
        ham.name == "Hubbard"
        and isinstance(prop, Continuous)
        and isinstance(prop.inner, HubbardContinuous)
        and prop.hybrid
        and not getattr(prop, "stochastic_ri", False)
        and not free_projection
        and not (nbp or nitcf or calc_one_rdm or calc_two_rdm)
        and getattr(trial, "psia", None) is not None
        and getattr(trial.psia, "ndim", 0) == 2
        and pop_method in ("comb", "pair_branch")
    )


def _greens_lanes(psi, phi):
    """(logdet [W], ghT [M, n, W], diag [M, W]) of one spin sector.

    Same math as ops/greens.greens_function on the [w, M, n] layout:
    S = phi^T conj(psi) (= (psi^dag phi)^T), Ghalf = S^-1 phi^T,
    diag(G)_q = sum_i psi*[q,i] Ghalf[i,q]. ghT is Ghalf transposed
    ([site, orbital, walker]).
    """
    s = jnp.swapaxes(ll.overlap_lanes(psi, phi), 0, 1)    # [n, n, W]
    phit = jnp.swapaxes(phi, 0, 1)                        # [n, M, W]
    logdet, gh = ll.gauss(s, phit)
    ght = jnp.swapaxes(gh, 0, 1)                          # [M, n, W]
    diag = jnp.sum(psi.conj()[:, :, None] * ght, axis=1)  # [M, W]
    return logdet, ght, diag


def _log_overlap_lanes(psi, phi):
    return ll.slogdet(ll.overlap_lanes(psi, phi))


@functools.partial(
    jax.jit,
    static_argnames=("nsteps", "nstblz", "npop_control", "pop_method",
                     "target_weight", "energy_eval_freq"),
)
def run_block_lanes(
    ham,
    trial,
    prop,
    state,
    block_key,
    eshift,
    step0,
    *,
    nsteps: int,
    nstblz: int,
    npop_control: int,
    pop_method: str,
    target_weight: float,
    energy_eval_freq: int,
):
    """Drop-in for qmc/afqmc.run_block on the supported subset: returns
    (state, mixed accumulator [2, NACC] real) — BP/ITCF accumulators are
    empty."""
    inner = prop.inner
    psia = trial.psia
    psib = trial.psib
    cdtype = state.log_ovlp.dtype
    rdtype = state.weight.dtype
    m = state.nbasis
    nw = state.nwalkers
    dt = prop.dt
    sqrt_dt = prop.sqrt_dt
    ebound = prop.ebound
    sqrt_u = inner.U ** 0.5
    # Trial-rotated kinetic contraction A_s = (psi_s^dag T_s)^T so that
    # ke = sum_qi A[q, i] ghT[q, i, W] without building the full G.
    t = jnp.asarray(ham.T, cdtype)
    ea = (psia.conj().T @ t[0]).T                          # [M, n]
    eb = (psib.conj().T @ t[1]).T

    def sel_mat(alive, new, old):
        return jnp.where(alive[None, None, :], new, old)

    def propagate(carry, kprop):
        phia, phib, weight, uw, log_ovlp, ehyb_prev, ldetr, tw = carry
        log_a, gha, da = _greens_lanes(psia, phia)
        log_b, ghb, db = _greens_lanes(psib, phib)
        log_o = (log_a + log_b).astype(cdtype)

        phia1 = ll.matmul_left(inner.BH1[0], phia)
        phib1 = ll.matmul_left(inner.BH1[1], phib)

        # Identical draw to two_body_factors: normal(key, (w, nfields)).
        xi = jax.random.normal(kprop, (nw, m), dtype=rdtype).T   # [M, W]
        if prop.force_bias:
            if inner.charge:
                vbias = 1j * sqrt_u * (da + db)
            else:
                vbias = sqrt_u * (da - db)
            xbar = -sqrt_dt * (vbias - inner.mf_shift[:, None])
            absx = jnp.abs(xbar)
            xbar = jnp.where(
                absx > 1.0, xbar / jnp.where(absx == 0, 1.0, absx), xbar
            )
        else:
            xbar = jnp.zeros((m, nw), cdtype)
        xshifted = xi - xbar
        cmf = -sqrt_dt * jnp.sum(
            xshifted * inner.mf_shift[:, None], axis=0
        )                                                     # [W]
        cfb = jnp.sum(xi * xbar, axis=0) - 0.5 * jnp.sum(xbar * xbar, axis=0)

        if inner.charge:
            gauge = jnp.exp(sqrt_dt * 1j * sqrt_u * xshifted)  # [M, W]
            phia1 = phia1 * gauge[:, None, :]
            phib1 = phib1 * gauge[:, None, :]
        else:
            gauge = jnp.exp((dt * inner.U) ** 0.5 * xshifted)
            phia1 = phia1 / gauge[:, None, :]
            phib1 = phib1 * gauge[:, None, :]

        phia1 = ll.matmul_left(inner.BH1[0], phia1)
        phib1 = ll.matmul_left(inner.BH1[1], phib1)

        log_new = (
            _log_overlap_lanes(psia, phia1)
            + _log_overlap_lanes(psib, phib1)
        ).astype(cdtype)

        log_ratio = log_new - log_o
        ehyb = -(log_ratio + cfb + cmf) / dt
        # _bound_hybrid (continuous.py:202-214).
        re = jnp.clip(ehyb.real, eshift.real - ebound, eshift.real + ebound)
        bounded = (re + 1j * ehyb.imag).astype(ehyb.dtype)
        ehyb = jnp.where(jnp.abs(eshift) < 1e-10, ehyb, bounded)
        log_imp = -dt * (0.5 * (ehyb + ehyb_prev) - eshift)
        magn = jnp.exp(log_imp.real)
        dtheta = (-dt * ehyb - cfb).imag
        cosine_fac = jnp.maximum(0.0, jnp.cos(dtheta))
        new_w = weight * magn * cosine_fac
        new_w = jnp.where(jnp.isfinite(new_w), new_w, 0.0)

        alive = jnp.abs(weight) > 1e-8
        return (
            sel_mat(alive, phia1, phia),
            sel_mat(alive, phib1, phib),
            jnp.where(alive, new_w, weight),
            uw,
            jnp.where(alive, log_new, log_ovlp),
            jnp.where(alive, ehyb, ehyb_prev),
            ldetr,
            tw,
        )

    def ortho(carry):
        phia, phib, weight, uw, log_ovlp, ehyb, ldetr, tw = carry
        qa, la = ll.cholesky_qr2(phia)
        qb, lb = ll.cholesky_qr2(phib)
        log_r = la + lb
        return (qa, qb, weight, uw,
                log_ovlp - log_r.astype(cdtype), ehyb,
                ldetr + log_r, tw)

    def pop(carry, kpop):
        phia, phib, weight, uw, log_ovlp, ehyb, ldetr, tw = carry
        if pop_method == "comb":
            parents, total = pc.comb_parents(weight, kpop, target_weight)
            # A dead population stays dead (see pop_control.comb).
            new_w = jnp.where(total > 0, 1.0, 0.0) * jnp.ones_like(weight)
        else:
            parents, new_w, total = pc.pair_branch_parents(
                weight, kpop, target_weight
            )

        def g(x):
            return jnp.take(x, parents, axis=-1)

        return (g(phia), g(phib), new_w, weight, g(log_ovlp), g(ehyb),
                g(ldetr), total)

    def mixed_acc(carry, eval_energy):
        phia, phib, weight, uw, log_ovlp, ehyb, ldetr, tw = carry
        wfac = weight.astype(cdtype)

        def with_energy(_):
            _, gha, da = _greens_lanes(psia, phia)
            _, ghb, db = _greens_lanes(psib, phib)
            ke = (jnp.sum(ea[:, :, None] * gha, axis=(0, 1))
                  + jnp.sum(eb[:, :, None] * ghb, axis=(0, 1)))
            if ham.symmetric:
                pe = -0.5 * ham.U * jnp.sum(da + db, axis=0)
            else:
                pe = ham.U * jnp.sum(da * db, axis=0)
            etot = ke + pe
            return (jnp.sum(wfac * etot.real), jnp.sum(wfac),
                    jnp.sum(wfac * ke.real), jnp.sum(wfac * pe.real))

        def without_energy(_):
            z = jnp.zeros((), cdtype)
            return z, z, z, z

        enumer, edenom, e1b, e2b = jax.lax.cond(
            eval_energy, with_energy, without_energy, None
        )
        return jnp.stack([
            jnp.sum(uw).astype(cdtype),
            jnp.sum(wfac),
            enumer,
            edenom,
            e1b,
            e2b,
            jnp.sum(wfac * ehyb),
            jnp.sum(weight * jnp.exp(log_ovlp.real)).astype(cdtype),
        ])

    def one_step(carry, inp):
        step, key = inp
        kprop, kpop, kest = jax.random.split(key, 3)
        del kest
        carry = jax.lax.cond(step % nstblz == 0, ortho, lambda c: c, carry)
        carry = propagate(carry, kprop)
        # Weight cap at 10% of total (afqmc.py:235-236).
        phia, phib, weight, uw, log_ovlp, ehyb, ldetr, tw = carry
        cap = 0.10 * tw
        weight = jnp.where((step > 1) & (jnp.abs(weight) > cap), cap, weight)
        carry = (phia, phib, weight, uw, log_ovlp, ehyb, ldetr, tw)
        carry = jax.lax.cond(
            step % npop_control == 0,
            lambda c: pop(c, kpop),
            lambda c: c,
            carry,
        )
        acc = mixed_acc(carry, step % energy_eval_freq == 0)
        return carry, acc

    carry0 = (
        ll.to_lanes(state.phia),
        ll.to_lanes(state.phib),
        state.weight,
        state.unscaled_weight,
        state.log_ovlp,
        state.hybrid_energy,
        state.log_detr,
        state.total_weight,
    )
    steps = step0 + 1 + jnp.arange(nsteps)
    keys = jax.random.split(block_key, nsteps)
    carry, accs = jax.lax.scan(one_step, carry0, (steps, keys))
    phia, phib, weight, uw, log_ovlp, ehyb, ldetr, tw = carry
    state = state.replace(
        phia=ll.from_lanes(phia),
        phib=ll.from_lanes(phib),
        weight=weight,
        unscaled_weight=uw,
        log_ovlp=log_ovlp,
        hybrid_energy=ehyb,
        log_detr=ldetr,
        total_weight=tw,
    )
    s = jnp.sum(accs, axis=0)
    return state, jnp.stack([s.real, s.imag])
