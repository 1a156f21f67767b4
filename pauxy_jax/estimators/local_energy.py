"""Local energy kernels, batched over walkers.

Batched counterparts of ``pauxy/estimators/hubbard.py:93-115``
(local_energy_hubbard), ``pauxy/estimators/generic.py:156-221``
(local_energy_generic_cholesky_opt) and the dispatch in
``pauxy/estimators/mixed.py:383-437``.

The batched device kernels take Green's functions with a leading walker axis
and return ``(etot, e1b, e2b)`` arrays of shape ``[w]``. The reference's
per-aux-vector Python loop (``generic.py:208-212``) becomes a single batched
contraction that XLA hands to its GEMM library.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# ----------------------------------------------------------------------------
# Hubbard
# ----------------------------------------------------------------------------

def local_energy_hubbard(ham, Ga: jax.Array, Gb: jax.Array):
    """Batched Hubbard local energy.

    ke = sum(T_up * G_up + T_dn * G_dn); pe = U sum_i G_up[ii] G_dn[ii]
    (symmetric form: pe = -U/2 (tr G_up + tr G_dn), ``hubbard.py:107-111``).
    """
    t = ham.T
    ke = jnp.einsum("mn,wmn->w", t[0], Ga) + jnp.einsum("mn,wmn->w", t[1], Gb)
    da = jnp.diagonal(Ga, axis1=-2, axis2=-1)
    db = jnp.diagonal(Gb, axis1=-2, axis2=-1)
    if ham.symmetric:
        pe = -0.5 * ham.U * (da.sum(-1) + db.sum(-1))
    else:
        pe = ham.U * jnp.sum(da * db, axis=-1)
    return ke + pe, ke, pe


def local_energy_hubbard_holstein(ham, Ga, Gb, X, shift):
    """Batched Hubbard-Holstein local energy
    (``pauxy/estimators/hubbard.py:51-91``): electron part as Hubbard,
    phonon potential/kinetic (trial-laplacian form) and the e-ph coupling.
    """
    from pauxy_jax.models import hubbard_holstein as hh

    etot_el, ke, pe = local_energy_hubbard(ham, Ga, Gb)
    pe_ph = 0.5 * ham.m * ham.w0 ** 2 * jnp.sum(X * X, axis=-1)
    lap = hh.ho_laplacian(X, ham.m, ham.w0, shift)
    ke_ph = -0.5 * jnp.sum(lap, axis=-1) / ham.m - 0.5 * ham.w0 * ham.nbasis
    da = jnp.diagonal(Ga, axis1=-2, axis2=-1)
    db = jnp.diagonal(Gb, axis1=-2, axis2=-1)
    rho = da + db
    e_eph = -ham.gsq2mw * jnp.sum(rho * X, axis=-1)
    etot = etot_el + pe_ph + ke_ph + e_eph
    return etot, ke + pe, pe_ph + ke_ph + e_eph


def local_energy_multi_coherent(ham, Gi, comp_w, X, lap):
    """Batched multi-coherent Hubbard-Holstein local energy.

    Batched rewrite of ``pauxy/estimators/mixed.py:450-458``
    (local_energy_multi_det_hh): component-weighted electron + e-ph terms,
    with the phonon kinetic term from the mixture trial-laplacian
    (lap = sum_p v_p lap phi_B,p / phi_B,p, which equals the reference's
    per-component weighting of Lapi pulled out of the sum).

    Gi [w, P, 2, M, M]; comp_w [w, P] normalized; X [w, M]; lap [w, M].
    """
    t = ham.T
    ke_p = (
        jnp.einsum("mn,wpmn->wp", t[0], Gi[:, :, 0], optimize=True)
        + jnp.einsum("mn,wpmn->wp", t[1], Gi[:, :, 1], optimize=True)
    )
    da = jnp.diagonal(Gi[:, :, 0], axis1=-2, axis2=-1)    # [w, P, M]
    db = jnp.diagonal(Gi[:, :, 1], axis1=-2, axis2=-1)
    pe_p = ham.U * jnp.sum(da * db, axis=-1)
    rho = da + db
    e_eph_p = -ham.gsq2mw * jnp.sum(rho * X[:, None, :], axis=-1)
    e_el = jnp.sum(comp_w * (ke_p + pe_p), axis=-1)
    e_eph = jnp.sum(comp_w * e_eph_p, axis=-1)
    pe_ph = 0.5 * ham.m * ham.w0 ** 2 * jnp.sum(X * X, axis=-1)
    ke_ph = -0.5 * jnp.sum(lap, axis=-1) / ham.m - 0.5 * ham.w0 * ham.nbasis
    etot = e_el + pe_ph + ke_ph + e_eph
    return etot, e_el, pe_ph + ke_ph + e_eph


# ----------------------------------------------------------------------------
# Generic (Cholesky-factorized ab-initio) — half-rotated fast path
# ----------------------------------------------------------------------------

def local_energy_generic_opt(trial, Ghalfa: jax.Array, Ghalfb: jax.Array,
                             ecore: float):
    """Batched ab-initio local energy from half-rotated Cholesky vectors.

    With rchol[x, i, m] = sum_p conj(psi[p, i]) L[p, m, x] and the
    half-rotated one-body rh1[i, m] = sum_p conj(psi[p, i]) H1[p, m]:

      e1b[w]   = sum_{i m} rh1a[i,m] Ghalfa[w,i,m]  (+ beta)
      X_s[w,x] = sum_{i m} rchol_s[x,i,m] Ghalf_s[w,i,m]
      ecoul[w] = (Xa + Xb) . (Xa + Xb)
      T_s[w,x,i,j] = sum_m rchol_s[x,i,m] Ghalf_s[w,j,m]
      exx_s[w] = sum_{x i j} T_s[w,x,i,j] T_s[w,x,j,i]
      e2b      = 0.5 (ecoul - exxa - exxb)

    Reference: ``pauxy/estimators/generic.py:156-221``. The exchange term is
    the FLOP hot spot (naux matmuls of [n,M]x[M,n] per walker); its
    [w, X, n, n] intermediate is chunked over the Cholesky axis when it
    would exceed ~2 GB so production (nmo, naux, nwalkers) fit in HBM.
    """
    from pauxy_jax.ops.contract import cr_einsum

    rca, rcb = trial.rchola, trial.rcholb            # [X, n, M]
    e1b = (
        cr_einsum("im,wim->w", trial.rh1a, Ghalfa, optimize=True)
        + cr_einsum("im,wim->w", trial.rh1b, Ghalfb, optimize=True)
    )
    xa = cr_einsum("xim,wim->wx", rca, Ghalfa, optimize=True)
    xb = cr_einsum("xim,wim->wx", rcb, Ghalfb, optimize=True)
    x = xa + xb
    ecoul = jnp.einsum("wx,wx->w", x, x)
    exx = (_exx(rca, Ghalfa, getattr(trial, "exx_supera", None))
           + _exx(rcb, Ghalfb, getattr(trial, "exx_superb", None)))
    e2b = 0.5 * (ecoul - exx)
    return e1b + e2b + ecore, e1b + ecore, e2b


def _exx(rchol: jax.Array, ghalf: jax.Array, exx_super=None,
         max_elems: int = 1 << 27) -> jax.Array:
    """exx[w] = sum_x tr(T_x(w) T_x(w)), T_x(w) = rchol_x Ghalf_w^T.

    Fastest path: the precomputed exchange supermatrix
    (models/trial._exx_supermatrix) turns the whole contraction into ONE
    dense [w, nM] x [nM, nM] matmul plus a row-wise dot:
    exx_w = vec(Ghalf_w)^T C vec(Ghalf_w) — 4x fewer FLOPs than the
    T-intermediate route and one large GEMM. Without it (over the size
    cap): a single einsum when the [w, X, n, n] intermediate is small;
    otherwise a ``lax.scan`` over Cholesky-axis chunks (the device-side
    equivalent of the reference's per-aux python loop at
    ``generic.py:208-212``, but batched chunk-wise into GEMMs).
    """
    from pauxy_jax.ops.contract import cr_einsum

    nx, n, _ = rchol.shape
    w = ghalf.shape[0]
    if exx_super is not None:
        gv = ghalf.reshape(w, -1)
        t = cr_einsum("pq,wq->wp", exx_super, gv, optimize=True)
        return jnp.einsum("wp,wp->w", gv, t)
    if w * nx * n * n <= max_elems:
        t = cr_einsum("xim,wjm->wxij", rchol, ghalf, optimize=True)
        return jnp.einsum("wxij,wxji->w", t, t)
    chunk = max(1, max_elems // (w * n * n))
    nchunks = -(-nx // chunk)
    pad = nchunks * chunk - nx
    rc = jnp.pad(rchol, ((0, pad), (0, 0), (0, 0)))  # zero chunks add zero
    rc = rc.reshape(nchunks, chunk, n, rchol.shape[-1])

    def body(acc, rck):
        t = cr_einsum("xim,wjm->wxij", rck, ghalf, optimize=True)
        return acc + jnp.einsum("wxij,wxji->w", t, t), None

    acc, _ = jax.lax.scan(body, jnp.zeros((w,), ghalf.dtype), rc)
    return acc


def local_energy_generic_opt_multi(trial, Ghalfa, Ghalfb, det_weights,
                                   ecore: float):
    """Det-batched ab-initio local energy for NOMSD trials.

    Per-determinant fast kernel (rchol_d, Ghalf_d as in
    :func:`local_energy_generic_opt`, with a leading determinant axis),
    det-averaged with the overlap weights w_d = conj(c_d) det_d / sum
    (the per-walker version of the reference's multi-det energy,
    ``pauxy/estimators/mixed.py:439-458`` + ``multi_slater.py:267-420``).

    Ghalf: [w, D, n, M]; rchol: [D, X, n, M]; det_weights: [w, D].
    """
    from pauxy_jax.ops.contract import cr_einsum

    rca, rcb = trial.rchola, trial.rcholb
    e1_d = (
        cr_einsum("dim,wdim->wd", trial.rh1a, Ghalfa, optimize=True)
        + cr_einsum("dim,wdim->wd", trial.rh1b, Ghalfb, optimize=True)
    )
    xa = cr_einsum("dxim,wdim->wdx", rca, Ghalfa, optimize=True)
    xb = cr_einsum("dxim,wdim->wdx", rcb, Ghalfb, optimize=True)
    x = xa + xb
    ecoul_d = jnp.einsum("wdx,wdx->wd", x, x)
    exx_per_det = jax.vmap(_exx, in_axes=(0, 1), out_axes=1)
    exx_d = exx_per_det(rca, Ghalfa) + exx_per_det(rcb, Ghalfb)
    e2_d = 0.5 * (ecoul_d - exx_d)
    e1b = jnp.sum(det_weights * e1_d, axis=-1) + ecore
    e2b = jnp.sum(det_weights * e2_d, axis=-1)
    return e1b + e2b, e1b, e2b


def local_energy_generic_exact_eri(trial, Ghalfa, Ghalfb, ecore: float):
    """Exact half-rotated-ERI local energy (``pauxy/estimators/generic.py:
    130-154``): E2 from the precomputed v_{ipjq} tensors, batched.
    """
    e1b = (
        jnp.einsum("im,wim->w", trial.rh1a, Ghalfa, optimize=True)
        + jnp.einsum("im,wim->w", trial.rh1b, Ghalfb, optimize=True)
        + ecore
    )
    ejaa = 0.5 * jnp.einsum("ipjq,wip,wjq->w", trial.eri_aa, Ghalfa, Ghalfa,
                            optimize=True)
    ejbb = 0.5 * jnp.einsum("ipjq,wip,wjq->w", trial.eri_bb, Ghalfb, Ghalfb,
                            optimize=True)
    ejab = jnp.einsum("ipjq,wip,wjq->w", trial.eri_ab, Ghalfa, Ghalfb,
                      optimize=True)
    ekaa = -0.5 * jnp.einsum("ipjq,wiq,wjp->w", trial.eri_aa, Ghalfa, Ghalfa,
                             optimize=True)
    ekbb = -0.5 * jnp.einsum("ipjq,wiq,wjp->w", trial.eri_bb, Ghalfb, Ghalfb,
                             optimize=True)
    e2b = ejaa + ejbb + ejab + ekaa + ekbb
    return e1b + e2b, e1b, e2b


def local_energy_generic_stochastic_ri(trial, Ghalfa, Ghalfb, ecore: float,
                                       key, nsamples: int,
                                       control_variate: bool):
    """Stochastic-RI exchange (``pauxy/estimators/generic.py:293-396``).

    The Coulomb term is exact (same X contraction as the fast path); the
    exchange is estimated with ``nsamples`` Rademacher probes theta over the
    Cholesky axis, optionally using the trial's exact exchange as a control
    variate. One shared probe set per call (the reference redraws per
    walker; sharing is the batched equivalent and keeps walkers correlated
    only within a single step's estimate).
    """
    rca, rcb = trial.rchola, trial.rcholb
    e1b = (
        jnp.einsum("im,wim->w", trial.rh1a, Ghalfa, optimize=True)
        + jnp.einsum("im,wim->w", trial.rh1b, Ghalfb, optimize=True)
        + ecore
    )
    xa = jnp.einsum("xim,wim->wx", rca, Ghalfa, optimize=True)
    xb = jnp.einsum("xim,wim->wx", rcb, Ghalfb, optimize=True)
    x = xa + xb
    ecoul = jnp.einsum("wx,wx->w", x, x)

    naux = rca.shape[0]
    theta = jax.random.rademacher(key, (naux, nsamples)).astype(rca.dtype)
    scale = 1.0 / nsamples

    def exx_stoch(rc, ghalf):
        # ra[i, p, s] = sum_X rchol[X, i, p] theta[X, s] / sqrt(S)
        ra = jnp.einsum("xip,xs->ips", rc, theta, optimize=True)
        gra = jnp.einsum("wkq,lqs->wlks", ghalf, ra, optimize=True)
        return scale * jnp.einsum("wlks,wkls->w", gra, gra, optimize=True)

    def exx_stoch_0(rc, ghalf0):
        ra = jnp.einsum("xip,xs->ips", rc, theta, optimize=True)
        gra = jnp.einsum("kq,lqs->lks", ghalf0, ra, optimize=True)
        return scale * jnp.einsum("lks,kls->", gra, gra, optimize=True)

    exxa = exx_stoch(rca, Ghalfa)
    exxb = exx_stoch(rcb, Ghalfb)
    if control_variate:
        _, exxa0, exxb0 = trial.e0_terms
        exxa = exxa0 + (exxa - exx_stoch_0(rca, trial.ghalf0a))
        exxb = exxb0 + (exxb - exx_stoch_0(rcb, trial.ghalf0b))
    e2b = 0.5 * (ecoul - exxa - exxb)
    return e1b + e2b, e1b, e2b


def local_energy_generic_pno(trial, Ghalfa, Ghalfb, ecore: float):
    """PNO-compressed local energy (``pauxy/estimators/generic.py:34-128``):
    E2 = 0.5(ecoul0 - exxa0 - exxb0) + per-pair SVD-truncated corrections
    relative to the trial, batched over walkers and pairs.
    """
    e1b = (
        jnp.einsum("im,wim->w", trial.rh1a, Ghalfa, optimize=True)
        + jnp.einsum("im,wim->w", trial.rh1b, Ghalfb, optimize=True)
        + ecore
    )

    def channel(pno, ga, gb, g0a, g0b, exchange: bool):
        idx_i, idx_j, coeff, u, vt = pno
        gi = ga[:, idx_i, :]                              # [w, n, M]
        gj = gb[:, idx_j, :]
        g0i = g0a[idx_i, :]                               # [n, M]
        g0j = g0b[idx_j, :]

        def dot_uv(a, b):                                 # [w, n]
            tu = jnp.einsum("wnp,npk->wnk", a, u, optimize=True)
            tv = jnp.einsum("wnp,nkp->wnk", b, vt, optimize=True)
            return jnp.einsum("wnk,wnk->wn", tu, tv)

        def dot_uv0(a, b):                                # [n]
            tu = jnp.einsum("np,npk->nk", a, u, optimize=True)
            tv = jnp.einsum("np,nkp->nk", b, vt, optimize=True)
            return jnp.einsum("nk,nk->n", tu, tv)

        ej = jnp.einsum("n,wn->w", coeff, dot_uv(gi, gj) - dot_uv0(g0i, g0j)[None])
        if not exchange:
            return ej, 0.0
        ek = -jnp.einsum("n,wn->w", coeff,
                         dot_uv(gj, gi) - dot_uv0(g0j, g0i)[None])
        return ej, ek

    ejaa, ekaa = channel(trial.pno_aa, Ghalfa, Ghalfa, trial.ghalf0a,
                         trial.ghalf0a, True)
    ejbb, ekbb = channel(trial.pno_bb, Ghalfb, Ghalfb, trial.ghalf0b,
                         trial.ghalf0b, True)
    ejab, _ = channel(trial.pno_ab, Ghalfa, Ghalfb, trial.ghalf0a,
                      trial.ghalf0b, False)
    ecoul0, exxa0, exxb0 = trial.e0_terms
    e2b = 0.5 * (ecoul0 - exxa0 - exxb0) + ejaa + ejbb + ejab + ekaa + ekbb
    return e1b + e2b, e1b, e2b


def local_energy_hubbard_ghf(ham, Gi: jax.Array, det_weights: jax.Array):
    """Batched GHF local energy for the Hubbard model.

    Batched rewrite of ``pauxy/estimators/hubbard.py:117-143``
    (local_energy_hubbard_ghf): Gi [w, D, 2M, 2M] per-determinant GHF
    Green's functions, det_weights [w, D] normalized overlap weights
    (conj(c_d) det_d / sum — so no denominator division here).

      ke = sum_d w_d Tr(Gi_d Text),  Text = blockdiag(T_up, T_dn)
      pe = U sum_d w_d sum_i (Guu_ii Gdd_ii - Gud_ii Gdu_ii)
    """
    t = ham.T
    m = t.shape[-1]
    ke = (
        jnp.einsum("wd,wdkl,kl->w", det_weights, Gi[:, :, :m, :m], t[0],
                   optimize=True)
        + jnp.einsum("wd,wdkl,kl->w", det_weights, Gi[:, :, m:, m:], t[1],
                     optimize=True)
    )
    guu = jnp.diagonal(Gi[:, :, :m, :m], axis1=-2, axis2=-1)
    gdd = jnp.diagonal(Gi[:, :, m:, m:], axis1=-2, axis2=-1)
    gud = jnp.diagonal(Gi[:, :, m:, :m], axis1=-2, axis2=-1)
    gdu = jnp.diagonal(Gi[:, :, :m, m:], axis1=-2, axis2=-1)
    pe = ham.U * jnp.einsum(
        "wd,wdi->w", det_weights, guu * gdd - gud * gdu, optimize=True
    )
    return ke + pe, ke, pe


def local_energy_generic_cholesky_G(ham, Ga: jax.Array, Gb: jax.Array):
    """Batched ab-initio local energy from the FULL Green's function (no
    trial half-rotation) — used for back-propagated G where the bra is not
    the trial. Reference: ``pauxy/estimators/generic.py:400-436``.
    """
    from pauxy_jax.ops.contract import cr_einsum, rc_einsum

    h1 = ham.H1
    chol = ham.chol                                       # [M, M, X]
    e1b = (cr_einsum("mn,wmn->w", h1[0], Ga)
           + cr_einsum("mn,wmn->w", h1[1], Gb))
    x = cr_einsum("ikx,wik->wx", chol, Ga + Gb, optimize=True)
    ecoul = jnp.einsum("wx,wx->w", x, x)
    exx = jnp.zeros_like(ecoul)
    for g in (Ga, Gb):
        t = rc_einsum("wil,ikx->wlkx", g, chol, optimize=True)
        exx = exx + jnp.einsum("wlkx,wklx->w", t, t, optimize=True)
    e2b = 0.5 * (ecoul - exx)
    return e1b + e2b + ham.ecore, e1b + ham.ecore, e2b


# ----------------------------------------------------------------------------
# UEG — gather/segment kernels replacing ueg_kernels.pyx
# ----------------------------------------------------------------------------

def coulomb_greens_function_ueg(ham, G: jax.Array):
    """(Gkpq, Gpmq) [w, nq]: sum_i G[i, idx(k_i +/- q)] over valid pairs.

    Batched rewrite of the Cython ``ueg_kernels.pyx:42-56`` per-q loops as one
    masked gather + reduction.
    """
    m = G.shape[-1]
    rows = jnp.arange(m)[None, :]                         # [1, M]
    gk = G[:, rows, ham.kpq_idx]                          # [w, nq, M]
    gp = G[:, rows, ham.pmq_idx]
    gkpq = jnp.sum(gk * ham.kpq_mask[None], axis=-1)
    gpmq = jnp.sum(gp * ham.pmq_mask[None], axis=-1)
    return gkpq, gpmq


def exchange_greens_function_ueg(ham, G: jax.Array, q_chunk: int | None = None,
                                 max_elems: int = 2 ** 26):
    """Gprod[w, q] = sum_{ij} G[j, idx(k_i+q)] G[i, idx(k_j-q)].

    The O(nnz^2)-per-q Cython loop (``ueg_kernels.pyx:58-75``) becomes, per
    q, an elementwise trace of two gathered matrices; chunked over q — and,
    when one q per step still exceeds the budget (large walker batches),
    over walkers too — to bound the [wc, qc, M, M] intermediates.
    """
    m = G.shape[-1]
    w = G.shape[0]
    if q_chunk is None:
        q_chunk = max(1, max_elems // max(1, 2 * w * m * m))
    if w * m * m * 2 > max_elems and w > 1:
        # One q already busts the budget: halve the walker batch recursively.
        half = w // 2
        return jnp.concatenate(
            [
                exchange_greens_function_ueg(ham, G[:half], None, max_elems),
                exchange_greens_function_ueg(ham, G[half:], None, max_elems),
            ],
            axis=0,
        )
    rows = jnp.arange(m)[None, :]

    def chunk(carry, idx):
        kpq_i, kpq_m, pmq_i, pmq_m = idx                  # each [qc, M]
        a = G[:, :, kpq_i] * kpq_m[None, None]            # [w, M(j), qc, M(i)]
        b = G[:, :, pmq_i] * pmq_m[None, None]            # [w, M(i), qc, M(j)]
        gp = jnp.einsum("wjqi,wiqj->wq", a, b, optimize=True)
        return carry, gp

    nq = ham.kpq_idx.shape[0]
    qc = min(q_chunk, nq)
    npad = (-nq) % qc

    def pad(x):
        return jnp.concatenate([x, jnp.zeros((npad,) + x.shape[1:], x.dtype)])

    idxs = jax.tree_util.tree_map(
        lambda x: pad(x).reshape(-1, qc, m),
        (ham.kpq_idx, ham.kpq_mask.astype(G.real.dtype),
         ham.pmq_idx, ham.pmq_mask.astype(G.real.dtype)),
    )
    _, gprod = jax.lax.scan(chunk, None, idxs)             # [nchunks, w, qc]
    return gprod.swapaxes(0, 1).reshape(G.shape[0], -1)[:, :nq]


def fft_coulomb_terms(psi, gh, gmap, qmap, qmesh):
    """(Gkpq, Gpmq)[w, nq] by FFT correlations (the Coulomb part of
    ``_fft_spin_terms``); also the propagator's force-bias expectations:
    <rho_q> = factor * Gkpq, <rho_q^T> = factor * Gpmq.

    One correlation cube serves both terms: C(Q) = sum_G ct(G) th(G-Q)
    gives Gkpq at Q and Gpmq at -Q exactly (rho_q^T = rho_{-q}), so the
    second [w, n, Ng] transform chain of the old formulation is a gather."""
    from pauxy_jax.propagation.pw_fft import fft3, ifft3, neg_perm

    qmesh = tuple(qmesh)
    ng = int(np.prod(qmesh))
    ct = _pw_cubes(jnp.swapaxes(psi.conj(), 0, 1), gmap, ng)
    th = _pw_cubes(gh, gmap, ng)
    cube = ifft3(
        jnp.einsum("ig,wig->wg", fft3(ct, qmesh), ifft3(th, qmesh),
                   optimize=True) * ng, qmesh
    )
    gkpq = cube[..., qmap]
    gpmq = cube[..., jnp.asarray(neg_perm(qmesh))[qmap]]
    return gkpq, gpmq


def _fft_spin_terms(psi, gh, gmap, qmap, qmesh, pair_chunk: int = 8):
    """(Gkpq, Gpmq, Gprod)[w, nq] of one spin channel by pseudo-spectral
    correlations on the FFT cube (``ueg_kernels.pyx:77-133``
    exchange_greens_function_fft, batched over walkers and occ pairs).

    psi [M, n] trial orbitals — or a per-walker bra [w, M, n] (the
    back-propagated wavefunction differs per walker); gh [w, n, M] is the
    half-rotated Green's function (G = psi* gh). The exchange pair tensor
    [w, nc, n, ngrid] is chunked over the first occupied index to bound
    memory.
    """
    from pauxy_jax.propagation.pw_fft import fft3, ifft3, neg_perm

    qmesh = tuple(qmesh)
    if psi.shape[-1] == 0:
        # Fully spin-polarized: an empty spin channel contributes nothing.
        z = jnp.zeros((gh.shape[0], qmap.shape[0]), gh.dtype)
        return z, z, z
    ng = int(np.prod(qmesh))
    wbra = psi.ndim == 3                                       # per-walker bra
    ct = _pw_cubes(jnp.swapaxes(psi.conj(), -1, -2), gmap, ng)  # [(w,) n, Ng]
    th = _pw_cubes(gh, gmap, ng)                               # [w, n, Ng]
    ct_f, th_if = fft3(ct, qmesh), ifft3(th, qmesh)
    n = psi.shape[-1]
    # Conventions match the gather kernels / reference (ueg.py:336-428):
    # with P[i,j](Q) = sum_G CT_i(G+Q) theta_j(G), the Coulomb terms are
    # Gpmq(q) = sum_i P[i,i](Q), Gkpq(q) = sum_i P[i,i](-Q) (the
    # theta*CT correlation at -Q; rho_q^T = rho_{-q}). The q-resolved
    # S(k) depends on the labeling even though the energy is invariant
    # under q -> -q. The exchange partner R[i,j](Q) = sum_G CT_j(G-Q)
    # theta_i(G) equals P[j,i](-Q), so ONE pair tensor serves
    # Gprod(Q) = sum_ij P[i,j](Q) R[i,j](Q) — the second [w, n, n, Ng]
    # transform chain of the old formulation is a transposed gather.
    nperm = jnp.asarray(neg_perm(qmesh))
    if n <= pair_chunk:
        pair = (ct_f[:, :, None] if wbra else ct_f[None, :, None]) \
            * th_if[:, None]
        p = ifft3(pair * ng, qmesh)                 # [w, i, j, Ng] complex
        diag = jnp.einsum("wiig->wg", p)
        gpmq = diag[..., qmap]
        gkpq = diag[..., nperm[qmap]]
        gprod = jnp.einsum("wijg,wjig->wg", p, p[..., nperm],
                           optimize=True)[..., qmap]
        return gkpq, gpmq, gprod
    # Chunked path for large occupations: bounds the pair-tensor memory
    # at [w, pair_chunk, n, Ng] by re-deriving R from its own transforms.
    ct_if, th_f = ifft3(ct, qmesh), fft3(th, qmesh)
    e_kpq = "wig,wig->wg" if wbra else "ig,wig->wg"
    e_pmq = "wig,wig->wg" if wbra else "wig,ig->wg"
    cube = ifft3(
        jnp.einsum(e_kpq, ct_f, th_if, optimize=True) * ng, qmesh
    )
    gpmq = cube[..., qmap]
    gkpq = cube[..., nperm[qmap]]
    gprod = None
    for i0 in range(0, n, pair_chunk):
        i1 = min(i0 + pair_chunk, n)
        if wbra:
            p = ifft3(ct_f[:, i0:i1, None] * th_if[:, None] * ng, qmesh)
            r = ifft3(th_f[:, i0:i1, None] * ct_if[:, None] * ng, qmesh)
        else:
            p = ifft3(ct_f[None, i0:i1, None] * th_if[:, None] * ng, qmesh)
            r = ifft3(th_f[:, i0:i1, None] * ct_if[None, None] * ng, qmesh)
        part = jnp.einsum("wijg,wijg->wg", p, r, optimize=True)
        gprod = part if gprod is None else gprod + part
    return gkpq, gpmq, gprod[..., qmap]


def structure_factor_ueg(ham, spin_factors):
    """S(k) blocks [w, 2, 2, nq] (``pauxy/estimators/ueg.py:71-82``).

    ``spin_factors`` is ((bra_a, gha), (bra_b, ghb)) with G_s = bra_s* gh_s
    — the FFT pseudo-spectral path (used by the mixed S(k)/two_rdm
    accumulators and the BP structure factor whenever the Green's function
    half-factorizes) — or ((Ga, None), (Gb, None)) dense, which falls back
    to the scan-launch-bound gather kernels (general-G path)."""
    (bra_a, gha), (bra_b, ghb) = spin_factors
    use_fft = getattr(ham, "gmap", None) is not None and gha is not None
    if use_fft:
        gkpq_a, gpmq_a, gprod_a = _fft_spin_terms(
            bra_a, gha, ham.gmap, ham.qmap, ham.qmesh
        )
        gkpq_b, gpmq_b, gprod_b = _fft_spin_terms(
            bra_b, ghb, ham.gmap, ham.qmap, ham.qmesh
        )
    else:
        def dense(bra, gh):
            if gh is None:
                return bra
            eq = "wmi,win->wmn" if bra.ndim == 3 else "mi,win->wmn"
            return jnp.einsum(eq, bra.conj(), gh, optimize=True)

        ga = dense(bra_a, gha)
        gb = dense(bra_b, ghb)
        gkpq_a, gpmq_a = coulomb_greens_function_ueg(ham, ga)
        gkpq_b, gpmq_b = coulomb_greens_function_ueg(ham, gb)
        gprod_a = exchange_greens_function_ueg(ham, ga)
        gprod_b = exchange_greens_function_ueg(ham, gb)
    return jnp.stack(
        [
            jnp.stack([gkpq_a * gpmq_a - gprod_a, gkpq_a * gpmq_b], 1),
            jnp.stack([gkpq_b * gpmq_a, gkpq_b * gpmq_b - gprod_b], 1),
        ],
        axis=1,
    )


def local_energy_ueg_half(ham, trial, gha: jax.Array, ghb: jax.Array):
    """Batched UEG local energy from half-rotated Green's functions via FFT
    correlations — O(w nocc^2 Ng log Ng) instead of the O(w nq M^2)
    gather-trace exchange; exact (the (4 nmax + 1)^3 cube holds every k +- q
    without aliasing). Port of the reference's own FFT kernel
    (``ueg_kernels.pyx:77-133``)."""
    diag_a = jnp.einsum("mi,wim->wm", trial.psia.conj(), gha, optimize=True)
    diag_b = jnp.einsum("mi,wim->wm", trial.psib.conj(), ghb, optimize=True)
    eig = jnp.diagonal(ham.H1[0])
    ke = jnp.einsum("m,wm->w", eig, diag_a + diag_b)

    gkpq_a, gpmq_a, gprod_a = _fft_spin_terms(
        trial.psia, gha, ham.gmap, ham.qmap, ham.qmesh
    )
    gkpq_b, gpmq_b, gprod_b = _fft_spin_terms(
        trial.psib, ghb, ham.gmap, ham.qmap, ham.qmesh
    )
    fac = 1.0 / (2.0 * ham.vol)
    vq = jnp.asarray(ham.vqvec)
    ess = jnp.einsum("q,wq->w", vq, gkpq_a * gpmq_a - gprod_a) + jnp.einsum(
        "q,wq->w", vq, gkpq_b * gpmq_b - gprod_b
    )
    eos = jnp.einsum("q,wq->w", vq, gkpq_a * gpmq_b) + jnp.einsum(
        "q,wq->w", vq, gkpq_b * gpmq_a
    )
    pe = fac * (ess + eos)
    return ke + pe, ke, pe


def local_energy_ueg(ham, Ga: jax.Array, Gb: jax.Array):
    """Batched UEG local energy (``pauxy/estimators/ueg.py:27-90``).

    pe = 1/(2 vol) sum_q v(q) [ (Gkpq_s Gpmq_s' summed over spin pairs)
                                - Gprod_up - Gprod_dn ].
    Madelung ecore is NOT added (matching the reference kernel).
    """
    ke = jnp.einsum("mn,wmn->w", ham.H1[0], Ga) + jnp.einsum(
        "mn,wmn->w", ham.H1[1], Gb
    )
    gkpq_a, gpmq_a = coulomb_greens_function_ueg(ham, Ga)
    gkpq_b, gpmq_b = coulomb_greens_function_ueg(ham, Gb)
    gprod_a = exchange_greens_function_ueg(ham, Ga)
    gprod_b = exchange_greens_function_ueg(ham, Gb)
    fac = 1.0 / (2.0 * ham.vol)
    vq = ham.vqvec
    ess = jnp.einsum("q,wq->w", vq, gkpq_a * gpmq_a - gprod_a) + jnp.einsum(
        "q,wq->w", vq, gkpq_b * gpmq_b - gprod_b
    )
    eos = jnp.einsum("q,wq->w", vq, gkpq_a * gpmq_b) + jnp.einsum(
        "q,wq->w", vq, gkpq_b * gpmq_a
    )
    pe = fac * (ess + eos)
    return ke + pe, ke, pe


# ----------------------------------------------------------------------------
# Host-side (numpy) energies for setup/validation
# ----------------------------------------------------------------------------

def local_energy_G_host(ham, G: np.ndarray):
    """Local energy from a single (unbatched) Green's function, host-side.

    Used during trial construction; mirrors ``mixed.py:383-437`` dispatch.
    """
    name = ham.name
    if name in ("Hubbard", "HubbardHolstein"):
        # HubbardHolstein: the reference's generic local_energy(system, G)
        # dispatch sends electron-only callers (e.g. trial construction)
        # to the electronic Hubbard kernel (mixed.py:404-408); the phonon
        # terms need walker coordinates and enter via the walker-batched
        # local_energy_hubbard_holstein instead.
        t = np.asarray(ham.T)
        ke = np.sum(t[0] * G[0] + t[1] * G[1])
        if ham.symmetric:
            pe = -0.5 * ham.U * (np.trace(G[0]) + np.trace(G[1]))
        else:
            pe = ham.U * np.dot(np.diagonal(G[0]), np.diagonal(G[1]))
        return ke + pe, ke, pe
    if name == "UEG":
        # Pure-numpy mirror of local_energy_ueg: setup runs host-side.
        h1 = np.asarray(ham.H1)
        ke = np.sum(h1[0] * G[0] + h1[1] * G[1])
        rows = np.arange(G[0].shape[-1])[None, :]
        kpq_idx = np.asarray(ham.kpq_idx)
        pmq_idx = np.asarray(ham.pmq_idx)
        kpq_m = np.asarray(ham.kpq_mask)
        pmq_m = np.asarray(ham.pmq_mask)
        gk = np.zeros((2, ham.nq), dtype=complex)
        gp = np.zeros((2, ham.nq), dtype=complex)
        gx = np.zeros((2, ham.nq), dtype=complex)
        for s in (0, 1):
            gs = np.asarray(G[s])
            gk[s] = np.sum(gs[rows, kpq_idx] * kpq_m, axis=-1)
            gp[s] = np.sum(gs[rows, pmq_idx] * pmq_m, axis=-1)
            a = gs[:, kpq_idx] * kpq_m[None]              # [M(j), nq, M(i)]
            b = gs[:, pmq_idx] * pmq_m[None]              # [M(i), nq, M(j)]
            gx[s] = np.einsum("jqi,iqj->q", a, b, optimize=True)
        vq = np.asarray(ham.vqvec)
        fac = 1.0 / (2.0 * ham.vol)
        ess = vq @ (gk[0] * gp[0] - gx[0] + gk[1] * gp[1] - gx[1])
        eos = vq @ (gk[0] * gp[1] + gk[1] * gp[0])
        pe = fac * (ess + eos)
        return ke + pe, ke, pe
    if name == "PW_FFT":
        # Host dense version with explicit momentum lookups (build-time
        # only; the batched path is local_energy_pw_fft).
        basis = np.asarray(ham.basis)
        lookup = {tuple(k): i for i, k in enumerate(basis)}
        eig = np.asarray(ham.sp_eigv)
        ke = np.dot(eig, np.diagonal(G[0]) + np.diagonal(G[1]))
        qvecs = np.asarray(ham.qvecs)
        vq = np.asarray(ham.vqvec)
        m = basis.shape[0]
        pe = 0.0 + 0j
        gk = np.zeros((2, len(qvecs)), dtype=complex)
        gp = np.zeros((2, len(qvecs)), dtype=complex)
        gx = np.zeros((2, len(qvecs)), dtype=complex)
        for iq, q in enumerate(qvecs):
            if vq[iq] == 0.0:
                continue
            kpq = [lookup.get(tuple(k + q)) for k in basis]
            pmq = [lookup.get(tuple(k - q)) for k in basis]
            for s in (0, 1):
                gk[s, iq] = sum(G[s][i, j] for i, j in enumerate(kpq)
                                if j is not None)
                gp[s, iq] = sum(G[s][i, j] for i, j in enumerate(pmq)
                                if j is not None)
                gx[s, iq] = sum(
                    G[s][j, kpq[i]] * G[s][i, pmq[j]]
                    for i in range(m) for j in range(m)
                    if kpq[i] is not None and pmq[j] is not None
                )
        fac = 1.0 / (2.0 * ham.vol)
        ess = np.dot(vq, gk[0] * gp[0] - gx[0]) + np.dot(
            vq, gk[1] * gp[1] - gx[1])
        eos = np.dot(vq, gk[0] * gp[1]) + np.dot(vq, gk[1] * gp[0])
        pe = fac * (ess + eos)
        return ke + pe, ke, pe
    if name == "Generic":
        # Dense reference contraction from the Cholesky factors:
        # full (ik|jl) = sum_x L[i,k,x] L[j,l,x].
        h1 = np.asarray(ham.H1)
        chol = np.asarray(ham.chol)                  # [M, M, X]
        e1b = np.sum(h1[0] * G[0]) + np.sum(h1[1] * G[1])
        gc = G[0] + G[1]
        xv = np.einsum("ikx,ik->x", chol, gc)
        ecoul = 0.5 * np.dot(xv, xv)
        exx = 0.0
        for gs in (G[0], G[1]):
            t = np.einsum("ikx,jk->ijx", chol, gs)
            exx += 0.5 * np.einsum("ijx,jix->", t, t)
        e2b = ecoul - exx
        return e1b + e2b + ham.ecore, e1b + ham.ecore, e2b
    raise NotImplementedError(f"local_energy_G_host for {name}")


# ---------------------------------------------------------------------------
# PW_FFT (FFT-grid UEG) — counterpart of pauxy/estimators/pw_fft.py:18-115.
# ---------------------------------------------------------------------------


def _pw_cubes(arr, gmap, ngrid):
    cube = jnp.zeros(arr.shape[:-1] + (ngrid,), arr.dtype)
    return cube.at[..., gmap].set(arr)


def local_energy_pw_fft(ham, trial, gha: jax.Array, ghb: jax.Array):
    """Batched FFT local energy from half-rotated Green's functions
    (``pw_fft.py:18-115``):

      Gkpq(Q) = sum_iG CT_i(G+Q) theta_i(G)
      Gpmq(Q) = sum_iG CT_i(G-Q) theta_i(G)
      Gprod(Q) = sum_ij [sum_G CT_i(G+Q) theta_j(G)]
                       [sum_G CT_j(G-Q) theta_i(G)]

    each evaluated as circular FFT convolutions on the qmesh cube (exact:
    correlations of mesh-supported functions never alias, models/pw_fft.py).
    """
    from pauxy_jax.propagation.pw_fft import fft3, ifft3

    qmesh = tuple(ham.qmesh)
    ng = int(np.prod(qmesh))
    gmap = jnp.asarray(ham.gmap)
    qmap = jnp.asarray(ham.qmap)
    psia = trial.psia
    psib = trial.psib

    diag_a = jnp.einsum("mi,wim->wm", psia.conj(), gha, optimize=True)
    diag_b = jnp.einsum("mi,wim->wm", psib.conj(), ghb, optimize=True)
    eig = jnp.asarray(ham.sp_eigv)
    ke = jnp.einsum("m,wm->w", eig, diag_a + diag_b)

    def spin_terms(psi, gh):
        ct = _pw_cubes(jnp.swapaxes(psi.conj(), 0, 1), gmap, ng)  # [n, Ng]
        th = _pw_cubes(gh, gmap, ng)                              # [w, n, Ng]
        ct_f, ct_if = fft3(ct, qmesh), ifft3(ct, qmesh)
        th_f, th_if = fft3(th, qmesh), ifft3(th, qmesh)
        gkpq = ifft3(
            jnp.einsum("ig,wig->wg", ct_f, th_if, optimize=True) * ng, qmesh
        )[..., qmap]
        gpmq = ifft3(
            jnp.einsum("wig,ig->wg", th_f, ct_if, optimize=True) * ng, qmesh
        )[..., qmap]
        # Exchange: P[i,j](Q) = sum_G CT_i(G+Q) theta_j(G),
        #           R[i,j](Q) = sum_G CT_j(G-Q) theta_i(G).
        p = ifft3(ct_f[None, :, None] * th_if[:, None] * ng, qmesh)
        r = ifft3(th_f[:, :, None] * ct_if[None, None] * ng, qmesh)
        gprod = jnp.einsum("wijg,wijg->wg", p, r, optimize=True)[..., qmap]
        return gkpq, gpmq, gprod

    gkpq_a, gpmq_a, gprod_a = spin_terms(psia, gha)
    gkpq_b, gpmq_b, gprod_b = spin_terms(psib, ghb)
    fac = 1.0 / (2.0 * ham.vol)
    vq = jnp.asarray(ham.vqvec)
    ess = jnp.einsum("q,wq->w", vq, gkpq_a * gpmq_a - gprod_a) + jnp.einsum(
        "q,wq->w", vq, gkpq_b * gpmq_b - gprod_b
    )
    eos = jnp.einsum("q,wq->w", vq, gkpq_a * gpmq_b) + jnp.einsum(
        "q,wq->w", vq, gkpq_b * gpmq_a
    )
    pe = fac * (ess + eos)
    return ke + pe, ke, pe
