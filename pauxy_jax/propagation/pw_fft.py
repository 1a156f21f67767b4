"""FFT two-body propagation for the plane-wave UEG (PW_FFT).

Batched counterpart of ``pauxy/propagation/pw.py:10-340``. The reference
applies the HS two-body propagator with per-orbital zero-padded scipy FFT
convolutions; here the whole population is one batched pseudo-spectral
update. Writing X+-(Q) for the scaled shifted fields, the reference's four
convolutions per Taylor order collapse into a single kernel

    A(Q) = i [X+(Q) + X+(-Q)] - [X-(Q) - X-(-Q)],
    (VHS phi)(G) = sum_Q A(Q) phi(G - Q),

evaluated as IFFT(FFT(A) * FFT(phi)) on the qmesh cube; FFT(rev X) is
computed as Ng * IFFT(X), so no explicit reversals appear. Each Taylor
order is truncated back to the basis sphere exactly like the reference's
'valid'-mode convolution (propagation/pw.py:133-150) — see
models/pw_fft.py for the no-aliasing argument.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config


def to_cube(arr, idx, ngrid: int):
    """Scatter [..., M] k-components into a flattened fft-order cube."""
    shape = arr.shape[:-1] + (ngrid,)
    cube = jnp.zeros(shape, arr.dtype)
    return cube.at[..., idx].set(arr)


# Dimension bound for the matmul-DFT path. UEG/PW_FFT cubes are always
# odd-sized ((4 nmax + 1)^3); for those a dense [d, d] DFT-matrix
# contraction per axis is exact, matmul-only and bandwidth-bound (3 passes
# over the cube). Power-of-2 sizes keep the native FFT. Whether the GPU's
# own FFT beats it at odd sizes is an open measurement (ROADMAP).
_MATMUL_DFT_MAX = 128

_DFT_MATS: dict = {}


def _dft_mat(n: int, inverse: bool) -> np.ndarray:
    """Dense 1-D DFT matrix with jnp.fft conventions (host numpy, cached;
    kept as numpy so jit embeds it as a constant)."""
    key = (n, inverse)
    mat = _DFT_MATS.get(key)
    if mat is None:
        k = np.arange(n)
        sign = 2j if inverse else -2j
        mat = np.exp((sign * np.pi / n) * np.outer(k, k))
        if inverse:
            mat = mat / n
        _DFT_MATS[key] = mat
    return mat


def _dft_mat2(d1: int, d2: int, inverse: bool) -> np.ndarray:
    """kron(F_d1, F_d2): one [d1 d2, d1 d2] matrix transforms two cube
    axes per matmul, a wider GEMM than two 1-D passes at small d."""
    key = (d1, d2, inverse)
    mat = _DFT_MATS.get(key)
    if mat is None:
        mat = np.kron(_dft_mat(d1, inverse), _dft_mat(d2, inverse))
        _DFT_MATS[key] = mat
    return mat


def _use_matmul_dft(qmesh) -> bool:
    return all(d <= _MATMUL_DFT_MAX and (d & (d - 1)) != 0 for d in qmesh)


def _dft3(cube_flat, qmesh, inverse: bool):
    """3-D DFT as two matmuls: axes (-2, -1) through the kron'd matrix,
    axis -3 through the 1-D matrix. Matmul precision INHERITS the ambient
    policy (config.set_matmul_precision): the float32 tier transforms at
    full f32 accuracy, the tensorfloat32 tier at its own — same semantics
    as every other contraction in the program."""
    d0, d1, d2 = tuple(qmesh)
    x = cube_flat.reshape(cube_flat.shape[:-1] + (d0, d1 * d2))
    f12 = jnp.asarray(_dft_mat2(d1, d2, inverse).astype(x.dtype))
    x = jnp.matmul(x, f12)
    f0 = jnp.asarray(_dft_mat(d0, inverse).astype(x.dtype))
    x = jnp.moveaxis(jnp.matmul(jnp.moveaxis(x, -2, -1), f0), -1, -2)
    return x.reshape(cube_flat.shape)


_NEG_PERMS: dict = {}


def neg_perm(qmesh) -> np.ndarray:
    """Flat cube index of -G for every G (host numpy, cached).

    Correlation cubes obey C2(Q) = C1(-Q) exactly (rho_q^T = rho_{-q}:
    the transposed density operator IS the negated-momentum one), so the
    second FFT chain of every Coulomb/exchange pair is a gather of the
    first through this permutation."""
    key = tuple(qmesh)
    perm = _NEG_PERMS.get(key)
    if perm is None:
        d0, d1, d2 = key
        a, b, c = np.meshgrid(
            np.arange(d0), np.arange(d1), np.arange(d2), indexing="ij"
        )
        perm = (((-a) % d0) * d1 + ((-b) % d1)) * d2 + ((-c) % d2)
        perm = perm.reshape(-1).astype(np.int32)
        _NEG_PERMS[key] = perm
    return perm


def fft3(cube_flat, qmesh):
    if _use_matmul_dft(qmesh):
        return _dft3(cube_flat, qmesh, inverse=False)
    x = cube_flat.reshape(cube_flat.shape[:-1] + tuple(qmesh))
    x = jnp.fft.fftn(x, axes=(-3, -2, -1))
    return x.reshape(cube_flat.shape)


def ifft3(cube_flat, qmesh):
    if _use_matmul_dft(qmesh):
        return _dft3(cube_flat, qmesh, inverse=True)
    x = cube_flat.reshape(cube_flat.shape[:-1] + tuple(qmesh))
    x = jnp.fft.ifftn(x, axes=(-3, -2, -1))
    return x.reshape(cube_flat.shape)


@struct.dataclass
class PWFFTInner:
    """Inner propagator for continuous.Continuous (diag BH1 + FFT VHS)."""

    BH1: jax.Array        # [2, M] DIAGONAL of exp(-dt/2 h1e_mod)
    mf_shift: jax.Array   # [2 nq] zeros (pw.py:40)
    vqfac: jax.Array      # [nq] sqrt(v_q / (4 V))
    vq_sqrtdt: jax.Array  # [nq] sqrt_dt * vqfac (kernel scaling)
    gmap: jax.Array       # [M]
    qmap: jax.Array       # [nq]
    ct_f_a: jax.Array     # [na, Ng] fft of conj up trial orbital cubes
    ct_if_a: jax.Array    # [na, Ng] ifft of same
    ct_f_b: jax.Array     # [nb, Ng]
    ct_if_b: jax.Array    # [nb, Ng]
    qmesh: tuple = struct.field(pytree_node=False)
    sqrt_dt: float = struct.field(pytree_node=False)
    exp_order: int = struct.field(pytree_node=False, default=6)

    @property
    def nq(self):
        return self.qmap.shape[0]

    @property
    def ngrid(self):
        return int(np.prod(self.qmesh))

    # ------------------------------------------------------------------
    def _gkpq_gpmq(self, ghalf, ct_f, ct_if):
        """Gkpq(Q) = sum_iG CT_i(G+Q) theta_i(G) and
        Gpmq(Q) = sum_iG CT_i(G-Q) theta_i(G), via FFT correlations
        (estimators/pw_fft.py:62-92)."""
        th = to_cube(ghalf, self.gmap, self.ngrid)         # [w, n, Ng]
        ng = self.ngrid
        th_f = fft3(th, self.qmesh)
        th_if = ifft3(th, self.qmesh)
        # conv(a, rev b) = IFFT(FFT(a) * Ng * IFFT(b))
        gkpq = ifft3(
            jnp.einsum("ig,wig->wg", ct_f, th_if, optimize=True) * ng,
            self.qmesh,
        )
        gpmq = ifft3(
            jnp.einsum("wig,ig->wg", th_f, ct_if, optimize=True) * ng,
            self.qmesh,
        )
        return gkpq[..., self.qmap], gpmq[..., self.qmap]  # [w, nq]

    def force_bias(self, trial, ga, gb):
        """xbar = -sqrt_dt vbias (pw.py:273-318): vplus = i(Gkpq + Gpmq),
        vminus = -(Gkpq - Gpmq), scaled by sqrt(v_q/(4V))."""
        ka, pa = self._gkpq_gpmq(ga.Ghalf, self.ct_f_a, self.ct_if_a)
        kb, pb = self._gkpq_gpmq(gb.Ghalf, self.ct_f_b, self.ct_if_b)
        gk, gp = ka + kb, pa + pb
        vplus = 1j * (gk + gp) * self.vqfac[None]
        vminus = -(gk - gp) * self.vqfac[None]
        return -self.sqrt_dt * jnp.concatenate([vplus, vminus], axis=-1)

    def apply_vhs(self, phia, phib, xshifted):
        """exp(VHS) phi by Taylor expansion with one FFT convolution per
        order (pw.py:120-155)."""
        nq = self.nq
        ng = self.ngrid
        cdtype = phia.dtype
        xp = (xshifted[:, :nq] * self.vq_sqrtdt[None]).astype(cdtype)
        xm = (xshifted[:, nq:] * self.vq_sqrtdt[None]).astype(cdtype)
        xp_c = to_cube(xp, self.qmap, ng)                  # [w, Ng]
        xm_c = to_cube(xm, self.qmap, ng)
        # FFT of A(Q) = i(Xp + rev Xp) - (Xm - rev Xm):
        # FFT(rev X) = Ng * IFFT(X).
        a_hat = (
            1j * (fft3(xp_c, self.qmesh) + ng * ifft3(xp_c, self.qmesh))
            - (fft3(xm_c, self.qmesh) - ng * ifft3(xm_c, self.qmesh))
        )                                                  # [w, Ng]
        mask = jnp.zeros((ng,), cdtype).at[self.gmap].set(1.0)

        def expv(phi):
            u = to_cube(jnp.swapaxes(phi, -1, -2), self.gmap, ng)  # [w,n,Ng]
            out = u
            for n in range(1, self.exp_order + 1):
                u = ifft3(a_hat[:, None, :] * fft3(u, self.qmesh),
                          self.qmesh) / n
                u = u * mask[None, None, :]
                out = out + u
            return jnp.swapaxes(out[..., self.gmap], -1, -2)

        return expv(phia), expv(phib)


def make_pw_fft_inner(ham, trial, dt: float, exp_order: int = 6,
                      precision=None) -> PWFFTInner:
    """Build the FFT inner propagator (pw.py:13-74)."""
    prec = config.get_precision(precision)
    from pauxy_jax.utils.transfer import to_device, to_host, device_zeros

    bh1 = np.exp(-0.5 * dt * np.asarray(ham.h1e_mod))      # diagonal
    vqfac = np.sqrt(np.asarray(ham.vqvec) / (4.0 * ham.vol))
    ng = int(np.prod(ham.qmesh))
    psia = np.asarray(to_host(trial.psia))
    psib = np.asarray(to_host(trial.psib))

    def ct_cubes(psi):
        cube = np.zeros((psi.shape[1], ng), dtype=complex)
        cube[:, np.asarray(ham.gmap)] = psi.conj().T
        return cube

    cta = ct_cubes(psia)
    ctb = ct_cubes(psib)
    mesh = ham.qmesh

    def f3(a):
        return np.fft.fftn(a.reshape(a.shape[:-1] + mesh),
                           axes=(-3, -2, -1)).reshape(a.shape)

    def if3(a):
        return np.fft.ifftn(a.reshape(a.shape[:-1] + mesh),
                            axes=(-3, -2, -1)).reshape(a.shape)

    return PWFFTInner(
        BH1=to_device(np.stack([bh1, bh1]).astype(prec.cplx)),
        mf_shift=device_zeros((2 * ham.nq,), prec.cplx),
        vqfac=to_device(vqfac.astype(prec.real)),
        vq_sqrtdt=to_device((dt ** 0.5 * vqfac).astype(prec.real)),
        gmap=to_device(np.asarray(ham.gmap)),
        qmap=to_device(np.asarray(ham.qmap)),
        ct_f_a=to_device(f3(cta).astype(prec.cplx)),
        ct_if_a=to_device(if3(cta).astype(prec.cplx)),
        ct_f_b=to_device(f3(ctb).astype(prec.cplx)),
        ct_if_b=to_device(if3(ctb).astype(prec.cplx)),
        qmesh=tuple(ham.qmesh),
        sqrt_dt=float(dt) ** 0.5,
        exp_order=int(exp_order),
    )
