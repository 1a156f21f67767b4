"""Discrete Hirsch site sweep as one Pallas kernel per walker block.

The CPMC two-body update (``pauxy/propagation/hubbard.py:172-220``) is a
*sequential* loop over lattice sites: each site's heat-bath probability
uses the inverse overlaps as updated by every previous flip. As a
``lax.scan`` (``propagation/hirsch.py``) each site is a handful of tiny
kernels over the whole population. Here one program owns a block of
``WB`` walkers and runs every site in a loop inside the kernel, with the
walker orbitals and inverse overlaps of both spins held on chip:

  phia [WB, M, N]   phib [WB, M, N]   inva/invb [WB, N, N]

M and N are padded to powers of two: padded sites are never visited, and
padded orbitals carry zero rows in phi and psi and an identity block in
the inverses, which the rank-1 updates leave untouched.

Real arithmetic only: the spin-decomposition Hirsch tables are real, and
for an untwisted lattice with a real trial the walkers stay real through
the constrained propagation (``hirsch.make_hirsch`` selects this kernel
only then). The field draw consumes the same uniforms ``rs[site, walker]``
as the scan path, so both paths follow the same trajectory up to float
reassociation. Lowered through Triton (``backend="triton"``); the tests
run it in interpret mode on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

# Walkers per program and warps per program: the fastest of 20 settings
# (4-64 walkers x 1-8 warps) at [1024, 16, 7] on an H100 (PERF.md).
WB = 32
NUM_WARPS = 4


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _sweep_kernel(nsites, tab_ref, psia_ref, psib_ref, phia_ref, phib_ref,
                  inva_ref, invb_ref, rs_ref, w_ref,
                  phia_out, phib_out, w_out, dlog_out, f_out):
    d00, d01, d10, d11 = tab_ref[0], tab_ref[1], tab_ref[2], tab_ref[3]
    wf0, wf1 = tab_ref[4], tab_ref[5]
    psia, psib = psia_ref[...], psib_ref[...]            # [M, N]
    rs = rs_ref[...]                                     # [WB, M]
    m = psia.shape[0]
    site_of_row = lax.broadcasted_iota(jnp.int32, (1, m, 1), 1)
    site_of_col = lax.broadcasted_iota(jnp.int32, (1, m), 1)
    site_of_psi = lax.broadcasted_iota(jnp.int32, (m, 1), 0)

    def gdiag(inv, row, u):
        # G_ii = sum_ab u[a] inv[b, a] row[b]  (hubbard.py:104-127).
        q = jnp.sum(inv * row[:, :, None], axis=1)       # [WB, N]
        return jnp.sum(q * u[None, :], axis=1)           # [WB]

    def sherman_morrison(inv, u, vt):
        # (S + u vt^T)^-1 from S^-1.
        t1 = jnp.sum(inv * u[None, None, :], axis=2)     # [WB, N]
        t2 = jnp.sum(vt[:, :, None] * inv, axis=1)       # [WB, N]
        denom = 1.0 + jnp.sum(vt * t1, axis=1)
        return inv - t1[:, :, None] * t2[:, None, :] / denom[:, None, None]

    def site(i, carry):
        phia, phib, inva, invb, w, dlog, fields = carry
        row_sel = site_of_row == i
        rowa = jnp.sum(jnp.where(row_sel, phia, 0.0), axis=1)   # [WB, N]
        rowb = jnp.sum(jnp.where(row_sel, phib, 0.0), axis=1)
        ua = jnp.sum(jnp.where(site_of_psi == i, psia, 0.0), axis=0)
        ub = jnp.sum(jnp.where(site_of_psi == i, psib, 0.0), axis=0)
        ga = gdiag(inva, rowa, ua)
        gb = gdiag(invb, rowb, ub)
        # Heat-bath probabilities (hubbard.py:535-556 + aux_wfac).
        p0 = 0.5 * (1.0 + d00 * ga) * (1.0 + d01 * gb) * wf0
        p1 = 0.5 * (1.0 + d10 * ga) * (1.0 + d11 * gb) * wf1
        pr0 = jnp.maximum(p0, 0.0)
        norm = pr0 + jnp.maximum(p1, 0.0)
        alive = (norm > 0.0) & (jnp.abs(w) > 0.0)
        safe = jnp.where(alive, norm, 1.0)
        r = jnp.sum(jnp.where(site_of_col == i, rs, 0.0), axis=1)
        xi = r >= pr0 / safe
        w = jnp.where(alive, w * norm, 0.0)
        chosen = jnp.where(xi, p1, p0)
        dlog = dlog + jnp.where(alive, jnp.log(2.0 * chosen), 0.0)
        da = jnp.where(alive, jnp.where(xi, d10, d00), 0.0)
        db = jnp.where(alive, jnp.where(xi, d11, d01), 0.0)
        vta = rowa * da[:, None]
        vtb = rowb * db[:, None]
        phia = phia + jnp.where(row_sel, vta[:, None, :], 0.0)
        phib = phib + jnp.where(row_sel, vtb[:, None, :], 0.0)
        inva = sherman_morrison(inva, ua, vta)
        invb = sherman_morrison(invb, ub, vtb)
        fields = jnp.where(site_of_col == i, xi.astype(jnp.int32)[:, None],
                           fields)
        return phia, phib, inva, invb, w, dlog, fields

    w0 = w_ref[...]
    carry = (phia_ref[...], phib_ref[...], inva_ref[...], invb_ref[...], w0,
             jnp.zeros_like(w0), jnp.zeros(rs.shape, jnp.int32))
    phia, phib, _, _, w, dlog, fields = lax.fori_loop(0, nsites, site, carry)
    phia_out[...] = phia
    phib_out[...] = phib
    w_out[...] = w
    dlog_out[...] = dlog
    f_out[...] = fields


@functools.partial(jax.jit, static_argnames=("interpret",))
def hirsch_sweep_real(psia, psib, delta, wfac, phia, phib, inva, invb, rs,
                      weight, interpret=False):
    """Run the Hirsch site sweep for a real spin-decomposed propagator.

    Args (all real, walker-major as in ``Hirsch._site_sweep``):
      psia/psib [M, na/nb]   trial orbitals
      delta [2, 2]           auxf - 1 tables
      wfac  [2]              aux_wfac
      phia/phib [w, M, n]    walker orbitals
      inva/invb [w, n, n]    inverse overlaps S^-1
      rs [M, w]              uniform field draws (the scan path's layout)
      weight [w]

    Returns (phia', phib', weight', dlog, fields [w, M] int32).
    """
    w, m, na = phia.shape
    nb = phib.shape[-1]
    dt = phia.dtype
    mp, n = _pow2(m), _pow2(max(na, nb, 1))
    wp = -(-w // WB) * WB

    def pad_orb(x, nx):                                  # [w, M, nx]
        return jnp.pad(x, ((0, wp - w), (0, mp - m), (0, n - nx)))

    def pad_inv(x, nx):                                  # identity block
        x = jnp.pad(x, ((0, wp - w), (0, n - nx), (0, n - nx)))
        fill = jnp.diag((jnp.arange(n) >= nx).astype(dt))
        return x + fill[None]

    tab = jnp.concatenate([delta.reshape(-1), wfac.reshape(-1),
                           jnp.zeros((2,), dt)]).astype(dt)
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))  # noqa: E731

    def blk(shape):
        return pl.BlockSpec((WB,) + shape,
                            lambda i: (i,) + (0,) * len(shape))

    out = pl.pallas_call(
        functools.partial(_sweep_kernel, m),
        grid=(wp // WB,),
        in_specs=[full((8,)), full((mp, n)), full((mp, n)),
                  blk((mp, n)), blk((mp, n)), blk((n, n)), blk((n, n)),
                  blk((mp,)), blk(())],
        out_specs=(blk((mp, n)), blk((mp, n)), blk(()), blk(()),
                   blk((mp,))),
        out_shape=(
            jax.ShapeDtypeStruct((wp, mp, n), dt),
            jax.ShapeDtypeStruct((wp, mp, n), dt),
            jax.ShapeDtypeStruct((wp,), dt),
            jax.ShapeDtypeStruct((wp,), dt),
            jax.ShapeDtypeStruct((wp, mp), jnp.int32),
        ),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=1),
        interpret=interpret,
        name="hirsch_site_sweep",
    )(
        tab,
        jnp.pad(psia.astype(dt), ((0, mp - m), (0, n - na))),
        jnp.pad(psib.astype(dt), ((0, mp - m), (0, n - nb))),
        pad_orb(phia, na), pad_orb(phib, nb), pad_inv(inva, na),
        pad_inv(invb, nb),
        jnp.pad(rs.T.astype(dt), ((0, wp - w), (0, mp - m)),
                constant_values=1.0),
        jnp.pad(weight.astype(dt), (0, wp - w)),
    )
    phia_o, phib_o, w_o, dlog_o, f_o = out
    return (phia_o[:w, :m, :na], phib_o[:w, :m, :nb], w_o[:w], dlog_o[:w],
            f_o[:w, :m])
