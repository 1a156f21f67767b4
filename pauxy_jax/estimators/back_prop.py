"""Back-propagated estimators.

Batched counterpart of ``pauxy/estimators/back_propagation.py:19-326``.
At every tau_bp interval, the trial wavefunction is propagated *backwards*
through the stored auxiliary-field history (one reverse ``lax.scan``, batched
over walkers), the back-propagated Green's function G = gab(phi_bp,
phi_old)^T is formed, and weighted energy / 1-RDM sums are accumulated.

Weight restoration options (BP-PRes, back_propagation.py:187-198):
  None      -> plain phaseless weight
  'partial' -> weight * prod(phase factors)
  'full'    -> weight * prod(phase factors) / prod(cosine factors)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pauxy_jax.ops import clinalg, greens


def _apply_bh1_dagger(bh1, phia, phib):
    if bh1.ndim == 2:                                     # diagonal B_{T/2}
        return (bh1[0].conj()[None, :, None] * phia,
                bh1[1].conj()[None, :, None] * phib)
    phia = jnp.einsum("mp,wmn->wpn", bh1[0].conj(), phia, optimize=True)
    phib = jnp.einsum("mp,wmn->wpn", bh1[1].conj(), phib, optimize=True)
    return phia, phib


def back_propagate_continuous(prop, trial, configs, nstblz: int):
    """phi_bp <- prod_j B(x_j)^dagger psi_T, reverse order with periodic
    re-orthogonalisation.

    ``prop`` is a Continuous propagator; B = BH1 e^{VHS} BH1 so
    B^dagger = BH1^dag e^{VHS^dag} BH1^dag (back_propagate_generic,
    pauxy/propagation/generic.py:253-290). e^{VHS(x)^dag} = e^{VHS(-conj(x))}
    because VHS(x) = i sqrt(dt) sum_n v_n x_n with Hermitian v_n.

    configs: [w, nbp, nfields] (most recent last).
    """
    inner = prop.inner
    nw, nbp, _ = configs.shape
    phia = jnp.broadcast_to(trial.psia[None], (nw,) + trial.psia.shape).astype(
        configs.dtype
    )
    phib = jnp.broadcast_to(trial.psib[None], (nw,) + trial.psib.shape).astype(
        configs.dtype
    )

    def body(carry, inp):
        phia, phib = carry
        j, x = inp
        phia, phib = _apply_bh1_dagger(inner.BH1, phia, phib)
        # exp(VHS(x))^dagger = exp(VHS(y)) with the model-specific field map.
        phia, phib = inner.apply_vhs(phia, phib, inner.bp_dagger_fields(x))
        phia, phib = _apply_bh1_dagger(inner.BH1, phia, phib)

        def ortho(p):
            q, _ = clinalg.cholesky_qr(p)
            return q

        do = (j != 0) & (j % nstblz == 0)
        phia = jax.lax.cond(do, ortho, lambda p: p, phia)
        phib = jax.lax.cond(do, ortho, lambda p: p, phib)
        return (phia, phib), None

    # Reverse order: most recent config first (generic.py:280).
    xs = jnp.flip(jnp.swapaxes(configs, 0, 1), axis=0)    # [nbp, w, nfields]
    (phia, phib), _ = jax.lax.scan(
        body, (phia, phib), (jnp.arange(nbp), xs)
    )
    return phia, phib


def back_propagate_hirsch(prop, trial, configs, nstblz: int):
    """Discrete-HS back propagation: B(x)^dag = BT2^dag diag(auxf[x])^dag
    BT2^dag (pauxy/propagation/hubbard.py:568-672)."""
    nw, nbp, m = configs.shape
    cdtype = prop.BT2.dtype
    phia = jnp.broadcast_to(trial.psia[None], (nw,) + trial.psia.shape).astype(cdtype)
    phib = jnp.broadcast_to(trial.psib[None], (nw,) + trial.psib.shape).astype(cdtype)
    bt2 = prop.BT2

    def body(carry, inp):
        phia, phib = carry
        j, x = inp                                        # x [w, M] in {0, 1}
        xi = jnp.real(x).astype(jnp.int32)
        ga = prop.auxf[xi, 0].conj()
        gb = prop.auxf[xi, 1].conj()
        phia, phib = _apply_bh1_dagger(bt2, phia, phib)
        phia = phia * ga[:, :, None]
        phib = phib * gb[:, :, None]
        phia, phib = _apply_bh1_dagger(bt2, phia, phib)

        def ortho(p):
            q, _ = clinalg.cholesky_qr(p)
            return q

        do = (j != 0) & (j % nstblz == 0)
        phia = jax.lax.cond(do, ortho, lambda p: p, phia)
        phib = jax.lax.cond(do, ortho, lambda p: p, phib)
        return (phia, phib), None

    xs = jnp.flip(jnp.swapaxes(configs, 0, 1), axis=0)
    (phia, phib), _ = jax.lax.scan(body, (phia, phib), (jnp.arange(nbp), xs))
    return phia, phib


def bp_greens_function(phia_bp, phib_bp, phia_old, phib_old):
    """G_s = gab(phi_bp_s, phi_old_s)^T, batched
    (back_propagation.py:157-158)."""
    ga = jnp.swapaxes(greens.gab(phia_bp, phia_old), -1, -2)
    gb = jnp.swapaxes(greens.gab(phib_bp, phib_old), -1, -2)
    return ga, gb


def bp_half_greens_function(phi_bp, phi_old):
    """Half factor gh [w, n, M] of the BP Green's function: with
    A = phi_bp, B = phi_old and G = gab(A, B)^T = conj(A) (A^dag B)^-T B^T,
    gh = (A^dag B)^-T B^T so that G = conj(A) gh — the per-walker-bra input
    of the FFT pseudo-spectral S(k) kernel."""
    adag = jnp.swapaxes(phi_bp.conj(), -1, -2)
    s = adag @ phi_old                                    # [w, n, n]
    return clinalg.solve(
        jnp.swapaxes(s, -1, -2), jnp.swapaxes(phi_old, -1, -2)
    )


def bp_weights(state, restore_weights: str | None):
    """BP weights incl. optional restoration (back_propagation.py:187-198)."""
    w = state.weight.astype(state.weight_fac.dtype)
    if restore_weights is None:
        return w
    ph = jnp.prod(state.weight_fac, axis=-1)
    if restore_weights == "full":
        cos = jnp.prod(state.cos_fac, axis=-1)
        safe = jnp.where(jnp.abs(cos) > 1e-300, cos, 1.0)
        return jnp.where(jnp.abs(cos) > 1e-300, w * ph / safe, 0.0)
    return w * ph


class BPReporter:
    """Host-side HDF5 push of block-summed BP accumulators.

    Dataset names match the reference (``back_propagation.py:285-326``):
    ``back_propagated/energies_{nbp}``, ``denominator_{nbp}``,
    ``one_rdm_{nbp}`` so ``pauxy.analysis.extraction.extract_rdm`` works.
    """

    def __init__(self, output, nbp: int, eval_energy: bool, nsplit: int = 1,
                 two_rdm_shape=None):
        self.output = output
        self.nbp = nbp
        self.eval_energy = eval_energy
        self.nsplit = nsplit
        self.splits = [(i + 1) * (nbp // nsplit) for i in range(nsplit)]
        self.two_rdm_shape = two_rdm_shape

    def block_row(self, acc, nbasis: int):
        import numpy as np

        acc = np.asarray(acc)
        per = acc.size // self.nsplit
        out = None
        for k, s in enumerate(self.splits):
            a = acc[k * per : (k + 1) * per]
            denom = a[3]
            self.output.push(np.array([denom]), f"denominator_{s}")
            if self.eval_energy and abs(denom) > 0:
                self.output.push(a[:3] / denom, f"energies_{s}")
            ng = 2 * nbasis * nbasis
            g = a[4 : 4 + ng].reshape(2, nbasis, nbasis)
            self.output.push(g, f"one_rdm_{s}")
            rest = a[4 + ng :]
            if self.two_rdm_shape is not None:
                n2 = int(np.prod(self.two_rdm_shape))
                self.output.push(rest[:n2].reshape(self.two_rdm_shape),
                                 f"two_rdm_{s}")
                rest = rest[n2:]
            if rest.size == ng:
                nmm = nbasis * nbasis
                self.output.push(rest[:nmm].reshape(nbasis, nbasis),
                                 f"fock_1p_{s}")
                self.output.push(rest[nmm:].reshape(nbasis, nbasis),
                                 f"fock_1h_{s}")
            if s == self.splits[-1]:
                out = a[:3] / denom if abs(denom) > 0 else a[:3]
        self.output.increment()
        return out


def bp_two_rdm_size(ham, calc_two_rdm: str | None) -> int:
    """Flat length of the optional BP 2-RDM tail
    (back_propagation.py:87-94): 'structure_factor' -> [2, 2, nq] (UEG),
    'full' -> [M, M, M, M] spin-summed."""
    if calc_two_rdm is None:
        return 0
    if calc_two_rdm == "structure_factor":
        if ham.name != "UEG":
            raise NotImplementedError("structure_factor 2-RDM is UEG-only")
        return 4 * ham.nq
    if calc_two_rdm == "full":
        return ham.nbasis ** 4
    raise NotImplementedError(f"unknown two_rdm mode {calc_two_rdm!r}")


def _two_rdm_flat(ham, calc_two_rdm: str, ga, gb, w):
    """Weighted 2-RDM tail summed over walkers.

    'full' (back_propagation.py:168-175): spin-summed
    <p+ q+ s r> = G(p,r,q,s) with same-spin exchange; accumulated directly
    as weighted einsums so the [M^4] tensor is never held per walker.
    'structure_factor' (estimators/ueg.py:71-82): S(k) blocks.
    """
    if calc_two_rdm == "full":
        def pair(x, y, exchange):
            t = jnp.einsum("w,wpr,wqs->prqs", w, x, y, optimize=True)
            if exchange:
                t = t - jnp.einsum("w,wps,wqr->prqs", w, x, y, optimize=True)
            return t
        rdm = (
            pair(ga, ga, True) + pair(gb, gb, True)
            + pair(ga, gb, False) + pair(gb, ga, False)
        )
        return rdm.reshape(-1)
    from pauxy_jax.estimators import local_energy as le

    sk = le.structure_factor_ueg(ham, ((ga, None), (gb, None)))
    return jnp.einsum("w,wabq->abq", w, sk).reshape(-1)


def update(ham, trial, prop, state, energy_fn, *, nstblz: int,
           restore_weights: str | None, discrete: bool,
           eval_ekt: bool = False, nbp_len: int | None = None,
           calc_two_rdm: str | None = None):
    """One BP measurement: returns the flat accumulator
    [e, e1b, e2b, denom, G.flatten() (, 2-RDM) (, EKT 1p/1h Focks)] summed
    over walkers. ``nbp_len`` restricts to the first n stored configs — the
    multi-split schedule measures at several BP times through the same
    buffer (back_propagation.py:70-72,144-147)."""
    configs = state.configs
    if nbp_len is not None:
        configs = configs[:, :nbp_len]
    if discrete:
        phia_bp, phib_bp = back_propagate_hirsch(prop, trial, configs, nstblz)
    else:
        phia_bp, phib_bp = back_propagate_continuous(prop, trial, configs, nstblz)
    ga, gb = bp_greens_function(phia_bp, phib_bp, state.phia_old, state.phib_old)
    w = bp_weights(state, restore_weights)
    if energy_fn is not None:
        etot, e1b, e2b = energy_fn(ga, gb)
    else:
        z = jnp.zeros_like(w)
        etot = e1b = e2b = z
    g = jnp.stack([ga, gb], axis=1)                       # [w, 2, M, M]
    parts = [
        jnp.stack(
            [
                jnp.sum(w * etot),
                jnp.sum(w * e1b),
                jnp.sum(w * e2b),
                jnp.sum(w),
            ]
        ),
        jnp.einsum("w,wsmn->smn", w, g).reshape(-1),
    ]
    if calc_two_rdm is not None:
        if (calc_two_rdm == "structure_factor"
                and getattr(ham, "gmap", None) is not None):
            # FFT pseudo-spectral S(k) with the per-walker BP bra — avoids
            # the scan-launch-bound q-chunk gather kernel (VERDICT r2 #4).
            from pauxy_jax.estimators import local_energy as le

            gha = bp_half_greens_function(phia_bp, state.phia_old)
            ghb = bp_half_greens_function(phib_bp, state.phib_old)
            sk = le.structure_factor_ueg(
                ham, ((phia_bp, gha), (phib_bp, ghb))
            )
            parts.append(jnp.einsum("w,wabq->abq", w, sk).reshape(-1))
        else:
            parts.append(_two_rdm_flat(ham, calc_two_rdm, ga, gb, w))
    if eval_ekt:
        # RDMs P = 1 - G^T per spin (back_propagation.py:199-218 + ekt.py).
        from pauxy_jax.estimators import ekt as ekt_mod

        m = ga.shape[-1]
        eye = jnp.eye(m, dtype=ga.dtype)
        pa = eye - jnp.swapaxes(ga, -1, -2)
        pb = eye - jnp.swapaxes(gb, -1, -2)
        f1p = ekt_mod.ekt_1p_fock(ham.H1[0], ham.chol, pa, pb)
        f1h = ekt_mod.ekt_1h_fock(ham.H1[0], ham.chol, pa, pb)
        parts.append(jnp.einsum("w,wmn->mn", w, f1p).reshape(-1))
        parts.append(jnp.einsum("w,wmn->mn", w, f1h).reshape(-1))
    return jnp.concatenate(parts)
