"""Pure-numpy stand-in for the reference's compiled Cython module
``pauxy.estimators.ueg_kernels`` (pauxy/estimators/ueg_kernels.pyx).

The oracle runs the read-only reference serially to generate golden
validation data; its single native component cannot be compiled here (no
Cython in the image), so this module implements the same functions in plain
numpy and is injected as ``sys.modules['pauxy.estimators.ueg_kernels']``
before pauxy imports it (see inject()). Test fixture only — pauxy_jax's
own UEG kernels live in pauxy_jax/estimators/local_energy.py.
"""

import math

import numpy

DTYPE_CX = numpy.complex128


def vq(q):
    q2 = numpy.dot(q, q)
    if q2 < 1e-10:
        return 0.0
    return 4 * math.pi / q2


def mod_one_body(T, basis, vol, kfac):
    h1e_mod = T.copy()
    fac = 1.0 / (2.0 * vol)
    for i, ki in enumerate(basis):
        for j, kj in enumerate(basis):
            if i != j:
                q = kfac * (ki - kj)
                h1e_mod[i, i] = h1e_mod[i, i] - fac * vq(q)
    return h1e_mod


def coulomb_greens_function_per_qvec(kpq_i, kpq, pmq_i, pmq, G):
    G = numpy.asarray(G)
    gkpq = G[numpy.asarray(kpq_i), numpy.asarray(kpq)].sum()
    gpmq = G[numpy.asarray(pmq_i), numpy.asarray(pmq)].sum()
    return gkpq, gpmq


def exchange_greens_function_per_qvec(kpq_i, kpq, pmq_i, pmq, G):
    G = numpy.asarray(G)
    kpq_i = numpy.asarray(kpq_i)
    kpq = numpy.asarray(kpq)
    pmq_i = numpy.asarray(pmq_i)
    pmq = numpy.asarray(pmq)
    # sum_{a in kpq, b in pmq} G[pmq_i[b], kpq[a]] * G[kpq_i[a], pmq[b]]
    return (
        G[pmq_i[:, None], kpq[None, :]] * G[kpq_i[None, :], pmq[:, None]]
    ).sum()


def exchange_greens_function_fft(nocc, nbsf, mesh, qmesh, gmap, qmap,
                                 CTdagger, Ghalf):
    from pauxy.estimators.utils import convolve

    ngrid = int(numpy.prod(mesh))
    nq = len(qmap)
    CTdagger = numpy.asarray(CTdagger)
    Ghalf = numpy.asarray(Ghalf)
    gprod = numpy.zeros(nq, dtype=DTYPE_CX)
    for i in range(nocc):
        for j in range(nocc):
            gh_i_cube = numpy.zeros(ngrid, dtype=DTYPE_CX)
            ct_j_cube = numpy.zeros(ngrid, dtype=DTYPE_CX)
            gh_i_cube[gmap] = numpy.flip(Ghalf[i, :])
            ct_j_cube[gmap] = CTdagger[j, :]
            lq_ji = numpy.flip(convolve(ct_j_cube, gh_i_cube, mesh))[qmap]

            gh_j_cube = numpy.zeros(ngrid, dtype=DTYPE_CX)
            ct_i_cube = numpy.zeros(ngrid, dtype=DTYPE_CX)
            gh_j_cube[gmap] = Ghalf[j, :]
            ct_i_cube[gmap] = numpy.flip(CTdagger[i, :])
            lq_ij = numpy.flip(convolve(gh_j_cube, ct_i_cube, mesh))[qmap]

            gprod += lq_ji * lq_ij
    return gprod


def build_J_opt(nq, vqvec, vol, nbsf, kpq_i, kpq, pmq_i, pmq, Gkpq, Gpmq):
    J = numpy.zeros([2, nbsf, nbsf], dtype=DTYPE_CX)
    for iq in range(nq):
        for i, j in zip(pmq_i[iq], pmq[iq]):
            J[0, j, i] += (1.0 / (2.0 * vol)) * vqvec[iq] * (
                Gpmq[0][iq] + Gpmq[1][iq]
            )
        for i, j in zip(kpq_i[iq], kpq[iq]):
            J[0, j, i] += (1.0 / (2.0 * vol)) * vqvec[iq] * (
                Gkpq[0][iq] + Gkpq[1][iq]
            )
    J[1] = J[0]
    return J


def build_K_opt(nq, vqvec, vol, nbsf, kpq_i, kpq, pmq_i, pmq, G):
    K = numpy.zeros([2, nbsf, nbsf], dtype=DTYPE_CX)
    G = numpy.asarray(G)
    for s in range(2):
        for iq in range(nq):
            for (idxjmq, idxj) in zip(pmq[iq], pmq_i[iq]):
                for (idxkpq, idxk) in zip(kpq[iq], kpq_i[iq]):
                    K[s, idxj, idxkpq] += (
                        -(1.0 / (2.0 * vol)) * vqvec[iq] * G[s, idxjmq, idxk]
                    )
            for (idxjpq, idxj) in zip(kpq[iq], kpq_i[iq]):
                for (idxpmq, idxp) in zip(pmq[iq], pmq_i[iq]):
                    K[s, idxj, idxpmq] += (
                        -(1.0 / (2.0 * vol)) * vqvec[iq] * G[s, idxjpq, idxp]
                    )
    return K


def inject():
    """Register this module as pauxy.estimators.ueg_kernels."""
    import sys

    sys.modules["pauxy.estimators.ueg_kernels"] = sys.modules[__name__]
