"""Low-rank thermal propagator stack (masked fixed-shape QDT truncation).

Batched counterpart of ``pauxy/walkers/stack.py:326-489``
(``PropagatorStack.update_low_rank``), the enabling feature for large-beta /
large-M finite-temperature AFQMC (He, Shi & Zhang, arXiv:1906.02247). The
path product A(tau) = B_T^{L-t-1} B(x_t)...B(x_1) is kept in factored form

    A = diag(Dl) . Qr diag(Dr) Tr

with the left (trial) part diagonal (low rank requires a diagonal trial
density matrix, ``stack.py:333``) and the right (stochastic) part a QDT
factorization re-orthogonalized at stack boundaries. Directions whose D
entry falls below ``thresh`` are numerically dead and the reference drops
them by shrinking the matrices (dynamic ranks mR/mL/mT). XLA needs static
shapes, so here rank truncation is a *mask*, never a shape: pivoted QR sorts
|diag R| descending, dead directions are zeroed in place, and every
inverse/determinant over the active mT x mT block is taken on an
identity-padded full-size matrix (inactive diagonal = 1 leaves det and
inverse of the active block unchanged). The per-spin overlap det(1 + A) is
tracked as a complex log (the reference keeps the raw determinant,
``stack.py:398``, which over/underflows at large beta).

All factors are batched [w, 2, ...] and the per-column-pivot sequential work
lives in ops/cpqr.py; the walker axis keeps the chip busy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax.ops import clinalg, cpqr


@struct.dataclass
class LowRankWalkerState:
    """Thermal walker population in low-rank stack form."""

    Qr: jax.Array           # [w, 2, M, M] right-product Q factor
    Dr: jax.Array           # [w, 2, M]    right-product D (|.| descending)
    Tr: jax.Array           # [w, 2, M, M] right-product T factor
    Dl: jax.Array           # [w, 2, M]    diagonal left (trial) product
    G: jax.Array            # [w, 2, M, M] current Green's function
    log_ovlp: jax.Array     # [w, 2] complex log det(1 + A) per spin
    weight: jax.Array       # [w]
    unscaled_weight: jax.Array
    phase: jax.Array        # [w] complex
    total_weight: jax.Array  # []
    hybrid_energy: jax.Array | None = None  # [w] see ThermalWalkerState

    @property
    def nwalkers(self) -> int:
        return self.Qr.shape[0]

    @property
    def nbasis(self) -> int:
        return self.Qr.shape[-1]


def _safe_inv(d: jax.Array, mask: jax.Array) -> jax.Array:
    """1/d where mask, else 0 (no inf/nan from dead directions)."""
    return jnp.where(mask, 1.0 / jnp.where(mask, d, 1.0), 0.0)


def _identity_pad(m: jax.Array, mask: jax.Array) -> jax.Array:
    """Put 1 on the diagonal of inactive rows/cols so det/inv of the padded
    matrix equal those of the active block."""
    mm = m.shape[-1]
    eye = jnp.eye(mm, dtype=m.dtype)
    return m + eye * (1.0 - mask.astype(m.dtype))[..., None, :]


def _green_from_clcr(clcr, t_in, mask_l, thresh):
    """Common tail of update_low_rank (``stack.py:372-420`` / ``:440-480``):
    pivoted QR of the combined left*right core, Db/Ds overflow splitting,
    G = 1 - Q D A T and log det(1 + A).

    clcr : [..., M, M] combined core diag(Dl) Q diag(D) (dead rows/cols 0)
    t_in : [..., M, M] row factor the new T multiplies into
    mask_l : [..., M] active left directions (rows of clcr / of Q2)
    Returns (G, log_ovlp, Tlcr, q2m, d2m) — the latter three are the
    theta/CT analogues (``stack.py:410-417``) for half-rotated estimators.
    """
    cdtype = clcr.dtype
    q2, r2, p2 = cpqr.cpqr(clcr)
    d2 = jnp.diagonal(r2, axis1=-2, axis2=-1)              # [..., M]
    mask_t = jnp.abs(d2) > thresh
    d2m = d2 * mask_t.astype(cdtype)

    tmp = _safe_inv(d2, mask_t)[..., :, None] * r2         # rows>mT zeroed
    tmp = cpqr.unpermute_columns(tmp, p2)
    tlcr = jnp.einsum("...pm,...mn->...pn", tmp, t_in)     # [..., M(mT), M]

    # Zero dead rows (the reference's explicit mL x mT embedding,
    # Qlcr_pad at stack.py:407-409) and dead columns of Q2.
    q2m = (
        q2
        * mask_l.astype(cdtype)[..., :, None]
        * mask_t.astype(cdtype)[..., None, :]
    )

    # Db/Ds splitting of the core determinant (stack.py:383-405).
    absd = jnp.abs(d2)
    big = absd > 1.0
    db = jnp.where(mask_t, jnp.where(big, 1.0 / jnp.where(big, absd, 1.0), 1.0), 1.0)
    ds = jnp.where(mask_t, jnp.where(big, d2 / jnp.where(big, absd, 1.0).astype(cdtype), d2), 0.0)
    db = db.astype(cdtype)

    tq = jnp.einsum("...pm,...mn->...pn", tlcr, q2m)       # active mT x mT
    tqp = _identity_pad(tq, mask_t)
    mm = tq.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(mm, dtype=cdtype), tq.shape)
    tq_inv = clinalg.solve(tqp, eye)
    core = tq_inv * db[..., None, :] + ds[..., None] * eye  # tmp at :389
    # det(1+A) = det(core) det(Db)^-1 det(TQ) assembled in the LOG domain
    # from the well-conditioned pieces: multiplying core by 1/db re-amplifies
    # the stabilized scales and slogdet of that product underflows to -inf
    # at long beta (cond ~ e^{beta W} > f64 pivoting).
    log_ovlp = (
        clinalg.slogdet(core)
        - jnp.sum(jnp.log(db), axis=-1)
        + clinalg.slogdet(tqp)
    )
    # Summed phases can leave the principal branch; wrap back so the value
    # matches log(det(...)) exactly (downstream exp() is branch-invariant,
    # but the stored overlap keeps the reference's principal convention).
    log_ovlp = log_ovlp.real + 1j * (
        jnp.mod(log_ovlp.imag + jnp.pi, 2 * jnp.pi) - jnp.pi
    )
    core_inv = clinalg.solve(core, eye)
    a = db[..., :, None] * jnp.einsum(
        "...pm,...mn->...pn", core_inv, tq_inv
    )
    at = jnp.einsum("...pm,...mn->...pn", a, tlcr)
    g = eye - jnp.einsum(
        "...pm,...mn->...pn", q2m * d2m[..., None, :], at
    )
    return g, log_ovlp, tlcr, q2m, d2m


@functools.partial(jax.jit, static_argnames=("stack_size", "thresh"))
def update_low_rank(
    btinv_diag: jax.Array,
    state: LowRankWalkerState,
    b: jax.Array,
    ts,
    *,
    stack_size: int,
    thresh: float,
):
    """Push one slice propagator B [w, 2, M, M] at time slice ts.

    At stack boundaries the right product is re-orthogonalized by pivoted QR
    before the left-right combine (``stack.py:337-420``); within a stack B
    accumulates into Qr and only the combine runs (``stack.py:421-480``).
    Returns the updated state with fresh G and log_ovlp.
    """
    cdtype = state.Qr.dtype
    dl = state.Dl * btinv_diag[None]                       # drop one left slice
    mask_l = jnp.abs(dl) > thresh
    dlm = dl * mask_l.astype(cdtype)

    mask_r = jnp.abs(state.Dr) > thresh
    qrb = jnp.einsum(
        "wspm,wsmn->wspn", b, state.Qr * mask_r.astype(cdtype)[..., None, :]
    )
    drm = state.Dr * mask_r.astype(cdtype)
    ccr = qrb * drm[..., None, :]

    def boundary(_):
        q1, r1, p1 = cpqr.cpqr(ccr)
        d1 = jnp.diagonal(r1, axis1=-2, axis2=-1)
        nz = jnp.abs(d1) > 0.0
        tmp = _safe_inv(d1, nz)[..., :, None] * r1
        tmp = cpqr.unpermute_columns(tmp, p1)
        t1 = jnp.einsum("...pm,...mn->...pn", tmp, state.Tr)
        clcr = dlm[..., :, None] * (q1 * d1[..., None, :])
        g, log_ovlp, _, _, _ = _green_from_clcr(clcr, t1, mask_l, thresh)
        return q1, d1, t1, g, log_ovlp

    def interior(_):
        clcr = dlm[..., :, None] * ccr
        g, log_ovlp, _, _, _ = _green_from_clcr(clcr, state.Tr, mask_l, thresh)
        return qrb, state.Dr, state.Tr, g, log_ovlp

    is_boundary = (ts % stack_size) == (stack_size - 1)
    qr_new, dr_new, tr_new, g, log_ovlp = jax.lax.cond(
        is_boundary, boundary, interior, None
    )
    return state.replace(
        Qr=qr_new, Dr=dr_new, Tr=tr_new, Dl=dl, G=g, log_ovlp=log_ovlp
    )


@functools.partial(jax.jit, static_argnames=("nwalkers",))
def init_low_rank_walkers(trial, nwalkers: int) -> LowRankWalkerState:
    """All paths at the trial: A = B_T^{num_slices} (diagonal), right = 1.

    G and log det(1+A) are exact closed forms of the diagonal left product
    (the reference computes them with a full QR stratification,
    ``walkers/thermal.py:59-66``).
    """
    m = trial.nbasis
    cdtype = trial.dmat.dtype
    rdtype = jnp.zeros((), cdtype).real.dtype
    bt_diag = jnp.diagonal(trial.dmat, axis1=-2, axis2=-1)  # [2, M]
    dl0 = bt_diag ** trial.num_slices
    dl = jnp.broadcast_to(dl0[None], (nwalkers, 2, m)).astype(cdtype)
    eye = jnp.broadcast_to(jnp.eye(m, dtype=cdtype), (nwalkers, 2, m, m))
    g = eye * (1.0 / (1.0 + dl))[..., None, :]
    log_ovlp = jnp.sum(jnp.log(1.0 + dl), axis=-1)
    return LowRankWalkerState(
        Qr=eye,
        Dr=jnp.ones((nwalkers, 2, m), cdtype),
        Tr=eye,
        Dl=dl,
        G=g,
        log_ovlp=log_ovlp,
        weight=jnp.ones((nwalkers,), rdtype),
        unscaled_weight=jnp.ones((nwalkers,), rdtype),
        phase=jnp.ones((nwalkers,), cdtype),
        total_weight=jnp.asarray(float(nwalkers), rdtype),
        hybrid_energy=jnp.zeros((nwalkers,), cdtype),
    )
