"""Imaginary-time correlation functions (single-particle Green's function).

Batched counterpart of ``pauxy/estimators/itcf.py:26-582``. Computes
G_greater(tau) = <c(tau) c^dagger> and G_lesser(tau) = <c^dagger c(tau)> for
both spins over a stored auxiliary-field path:

1. phi_left = psi_T back-propagated through the stored configs (reverse
   lax.scan, optionally storing intermediate left wavefunctions),
2. equal-time G at the path start from (phi_left, phi_right-snapshot),
3. forward lax.scan over slices applying dense propagator matrices B(x):
   unstable: Ggr <- B Ggr, Gls <- Gls B^-1 (itcf.py:419-467);
   stable (Feldbacher-Assaad, PRB 63, 073105): products of well-conditioned
   single-slice terms Ggr <- (B Gnn_gr) Ggr, Gls <- Gls (Gnn_ls B^-1) with
   the equal-time Gnn re-derived each slice from stored left wavefunctions
   and the advanced right wavefunction (itcf.py:227-305, 469-497).

Everything is batched over walkers; accumulation happens in-jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pauxy_jax.ops import clinalg, greens


def dense_propagators(prop, configs_t, discrete: bool):
    """Dense B = [Ba, Bb] ([w, M, M] each) for one stored config row.

    Continuous: B = BH1 e^{VHS(x)} BH1 (continuous.py:176 analogue at T=0);
    discrete: B = BT2 diag(auxf[x, s]) BT2 (hubbard.py:568-601).
    """
    nw = configs_t.shape[0]
    if discrete:
        bt2 = prop.BT2
        m = bt2.shape[-1]
        xi = jnp.real(configs_t).astype(jnp.int32)        # [w, M]
        ga = prop.auxf[xi, 0]
        gb = prop.auxf[xi, 1]
        left_a = bt2[0][None] * ga[:, None, :]            # BT2 @ diag(g)
        left_b = bt2[1][None] * gb[:, None, :]
        ba = jnp.einsum("wpm,mn->wpn", left_a, bt2[0], optimize=True)
        bb = jnp.einsum("wpm,mn->wpn", left_b, bt2[1], optimize=True)
        return ba, bb
    inner = prop.inner
    bh1 = inner.BH1
    m = bh1.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(m, dtype=bh1.dtype), (nw, m, m))
    # exp(VHS) as a dense matrix: apply the exponential to the identity.
    ev_a, ev_b = inner.apply_vhs(eye, eye, configs_t)
    if bh1.ndim == 2:                                     # diagonal B_{T/2}
        ba = bh1[0][None, :, None] * ev_a * bh1[0][None, None, :]
        bb = bh1[1][None, :, None] * ev_b * bh1[1][None, None, :]
        return ba, bb
    ba = jnp.einsum("pm,wmq,qn->wpn", bh1[0], ev_a, bh1[0], optimize=True)
    bb = jnp.einsum("pm,wmq,qn->wpn", bh1[1], ev_b, bh1[1], optimize=True)
    return ba, bb


def equal_time_greens(phia_l, phib_l, phia_r, phib_r):
    """(Ggr, Gls) per spin: Ggr = I - gab(L, R), Gls = gab(L, R)
    (itcf.py:306-337)."""
    m = phia_l.shape[1]
    eye = jnp.eye(m, dtype=phia_l.dtype)
    gls_a = greens.gab(phia_l, phia_r)
    gls_b = greens.gab(phib_l, phib_r)
    return (eye - gls_a, eye - gls_b), (gls_a, gls_b)


def back_propagate_left(prop, trial, configs, nstblz: int, discrete: bool):
    """Back-propagate psi_T through all stored configs (reverse order),
    storing the left wavefunction after every slice.

    Returns (phia_left_final, phib_left_final, stored_la, stored_lb) where
    stored_l*[j] is the left wavefunction after consuming the last j+1
    configs (i.e. the bra at slice nprop-1-j).
    """
    nw, nprop, _ = configs.shape
    cdtype = prop.BT2.dtype if discrete else prop.inner.BH1.dtype
    phia = jnp.broadcast_to(trial.psia[None], (nw,) + trial.psia.shape).astype(cdtype)
    phib = jnp.broadcast_to(trial.psib[None], (nw,) + trial.psib.shape).astype(cdtype)

    def body(carry, inp):
        phia, phib = carry
        j, x = inp
        ba, bb = dense_propagators(prop, x, discrete)
        phia = jnp.einsum("wmp,wmn->wpn", ba.conj(), phia, optimize=True)
        phib = jnp.einsum("wmp,wmn->wpn", bb.conj(), phib, optimize=True)

        def ortho(p):
            q, _ = clinalg.cholesky_qr(p)
            return q

        do = (j != 0) & (j % nstblz == 0)
        phia = jax.lax.cond(do, ortho, lambda p: p, phia)
        phib = jax.lax.cond(do, ortho, lambda p: p, phib)
        return (phia, phib), (phia, phib)

    xs = jnp.flip(jnp.swapaxes(configs, 0, 1), axis=0)
    (phia, phib), (la, lb) = jax.lax.scan(
        body, (phia, phib), (jnp.arange(nprop), xs)
    )
    return phia, phib, la, lb


def measure(prop, trial, state, *, nmax: int, nstblz: int, stable: bool,
            restore_weights: bool, discrete: bool, stack_size: int = 1):
    """One ITCF measurement. Returns flat [1 + (nmax//stack_size+1)*2*2*M*M]
    accumulator (denominator first), summed over walkers. ``stack_size``
    records G(tau) only at every stack_size-th slice
    (``pauxy/estimators/itcf.py:85-89`` ntau = nmax/stack_size)."""
    m = state.nbasis
    configs = state.configs
    phia_l, phib_l, la, lb = back_propagate_left(
        prop, trial, configs, nstblz, discrete
    )
    (ggr_a, ggr_b), (gls_a, gls_b) = equal_time_greens(
        phia_l, phib_l, state.phia_right, state.phib_right
    )

    if restore_weights:
        ph = jnp.prod(state.weight_fac, axis=-1)
        cos = jnp.prod(state.cos_fac, axis=-1)
        safe = jnp.where(jnp.abs(cos) > 1e-300, cos, 1.0)
        wfac = jnp.where(
            jnp.abs(cos) > 1e-300,
            state.weight.astype(ph.dtype) * ph / safe,
            0.0,
        )
    else:
        wfac = state.weight.astype(state.log_ovlp.dtype)

    def acc_slice(ggr_a, ggr_b, gls_a, gls_b):
        # [2(spin), 2(gr/ls), M, M] weighted sum over walkers
        # (itcf.py:381-399 accumulate_uhf).
        g = jnp.stack(
            [jnp.stack([ggr_a, gls_a], 0), jnp.stack([ggr_b, gls_b], 0)], 0
        )  # [2(spin), 2(gr/ls), w, M, M]
        return jnp.einsum("w,sewmn->semn", wfac, g)

    spgf0 = acc_slice(ggr_a, ggr_b, gls_a, gls_b)

    nn_gr = (ggr_a, ggr_b)
    nn_ls = (gls_a, gls_b)
    cum_gr = nn_gr
    cum_ls = nn_ls

    def body(carry, inp):
        cum_gr_a, cum_gr_b, cum_ls_a, cum_ls_b, pra, prb = carry
        ic, x = inp
        ba, bb = dense_propagators(prop, x, discrete)
        if stable:
            # Left bra at this slice: stored la[nprop-1-ic].
            la_ic = jnp.flip(la, 0)[ic]
            lb_ic = jnp.flip(lb, 0)[ic]
            (nn_gr_a, nn_gr_b), (nn_ls_a, nn_ls_b) = equal_time_greens(
                la_ic, lb_ic, pra, prb
            )
            cum_gr_a = jnp.einsum(
                "wpm,wmq,wqn->wpn", ba, nn_gr_a, cum_gr_a, optimize=True
            )
            cum_gr_b = jnp.einsum(
                "wpm,wmq,wqn->wpn", bb, nn_gr_b, cum_gr_b, optimize=True
            )
            # Gls <- Gls (Gnn_ls B^-1): solve on the right via transposes.
            t_a = clinalg.solve(
                jnp.swapaxes(ba, -1, -2), jnp.swapaxes(nn_ls_a, -1, -2)
            )
            t_b = clinalg.solve(
                jnp.swapaxes(bb, -1, -2), jnp.swapaxes(nn_ls_b, -1, -2)
            )
            cum_ls_a = jnp.einsum(
                "wpm,wnm->wpn", cum_ls_a, t_a, optimize=True
            )
            cum_ls_b = jnp.einsum(
                "wpm,wnm->wpn", cum_ls_b, t_b, optimize=True
            )
            # Advance the right wavefunction phi_r <- B phi_r with periodic
            # reortho (itcf.py:283-296).
            pra = jnp.einsum("wpm,wmn->wpn", ba, pra, optimize=True)
            prb = jnp.einsum("wpm,wmn->wpn", bb, prb, optimize=True)

            def ortho(p):
                q, _ = clinalg.cholesky_qr(p)
                return q

            do = (ic != 0) & (ic % nstblz == 0)
            pra = jax.lax.cond(do, ortho, lambda p: p, pra)
            prb = jax.lax.cond(do, ortho, lambda p: p, prb)
        else:
            cum_gr_a = jnp.einsum("wpm,wmn->wpn", ba, cum_gr_a, optimize=True)
            cum_gr_b = jnp.einsum("wpm,wmn->wpn", bb, cum_gr_b, optimize=True)
            # Gls <- Gls B^-1  via (B^T X^T = Gls^T).
            t_a = clinalg.solve(
                jnp.swapaxes(ba, -1, -2), jnp.swapaxes(cum_ls_a, -1, -2)
            )
            t_b = clinalg.solve(
                jnp.swapaxes(bb, -1, -2), jnp.swapaxes(cum_ls_b, -1, -2)
            )
            cum_ls_a = jnp.swapaxes(t_a, -1, -2)
            cum_ls_b = jnp.swapaxes(t_b, -1, -2)
        out = acc_slice(cum_gr_a, cum_gr_b, cum_ls_a, cum_ls_b)
        return (cum_gr_a, cum_gr_b, cum_ls_a, cum_ls_b, pra, prb), out

    xs = jnp.swapaxes(configs[:, :nmax, :], 0, 1)         # forward order
    carry0 = (
        cum_gr[0], cum_gr[1], cum_ls[0], cum_ls[1],
        state.phia_right.astype(spgf0.dtype), state.phib_right.astype(spgf0.dtype),
    )
    _, spgf_rest = jax.lax.scan(body, carry0, (jnp.arange(nmax), xs))

    spgf = jnp.concatenate([spgf0[None], spgf_rest], axis=0)  # [nmax+1,2,2,M,M]
    if stack_size > 1:
        spgf = spgf[::stack_size]
    denom = jnp.sum(wfac)
    return jnp.concatenate([denom[None], spgf.reshape(-1)])


def itcf_to_kspace(spgf, nx: int, ny: int):
    """FFT the real-space ITCF onto the lattice momentum grid.

    G_k(tau) = (1/M) sum_{ij} e^{-ik(r_i - r_j)} G_ij(tau), evaluated as a
    2D FFT over both site indices. This is the intent of the reference's
    (commented-out) k-space branch, ``pauxy/estimators/itcf.py:547-557``.
    Returns [..., M] diagonal momentum occupations per tau/spin/order.
    """
    import numpy as np

    m = nx * ny
    shape = spgf.shape[:-2]
    g = spgf.reshape(*shape, ny, nx, ny, nx)
    # e^{-ik r_i} forward over the first site, e^{+ik r_j} inverse over the
    # second: G_k = F G F^dagger / M.
    gk = np.fft.fft2(g, axes=(-4, -3))
    gk = np.fft.ifft2(gk, axes=(-2, -1)) * m
    gk = gk.reshape(*shape, m, m) / m
    return np.einsum("...kk->...k", gk)


class ITCFReporter:
    """Host-side HDF5 push (layout: ``itcf/real_space_greens_function`` +
    ``itcf/denominator``, optional ``itcf/k_space_greens_function``;
    cf. itcf.py print_step)."""

    def __init__(self, output, kspace_dims=None, mode="full"):
        self.output = output
        self.kspace_dims = kspace_dims  # (nx, ny) to also write G_k
        # Output mode (itcf.py:40-44,570-575): 'full' writes the whole
        # [ntau+1, 2, 2, M, M] tensor, 'diagonal' only G_ii(tau), a list of
        # (i, j) pairs only those elements.
        self.mode = mode

    def _select(self, spgf):
        import numpy as np

        if self.mode == "full":
            return spgf
        if self.mode == "diagonal":
            return np.einsum("...ii->...i", spgf)
        pairs = np.asarray(self.mode, dtype=int).reshape(-1, 2)
        return spgf[..., pairs[:, 0], pairs[:, 1]]

    def block_row(self, acc, nbasis: int, nmax: int):
        import numpy as np

        denom = acc[0]
        spgf = acc[1:].reshape(nmax + 1, 2, 2, nbasis, nbasis)
        if abs(denom) > 0:
            spgf = spgf / denom
        self.output.push(self._select(spgf).real, "real_space_greens_function")
        if self.kspace_dims is not None:
            gk = itcf_to_kspace(spgf, *self.kspace_dims)
            self.output.push(gk.real, "k_space_greens_function")
        self.output.push(np.array([denom]), "denominator")
        self.output.increment()
        return spgf
