"""k-point factorized Hamiltonian reader round trip + supercell assembly.

Reference layout: ``pauxy/utils/hamiltonian_converter.py:356-419`` (reader)
and the FCIDUMP assembly loop (``:500-530``) as the ERI oracle.
"""

import numpy as np
import pytest

from pauxy_jax.utils import hamiltonian_converter as hc


def synthetic_kpoint(nkp=3, nmo=2, nchol=4, seed=5):
    """Random k-point Hamiltonian on a ring of nkp k-points: Q + k = k'
    modular arithmetic gives QKTok2[q, k] = (k - q) % nkp and
    MinusK[q] = (-q) % nkp."""
    rng = np.random.default_rng(seed)
    nmo_pk = np.full(nkp, nmo, dtype=np.int32)
    nchol_pk = np.full(nkp, nchol, dtype=np.int32)
    qk_k2 = np.array(
        [[(k - q) % nkp for k in range(nkp)] for q in range(nkp)],
        dtype=np.int32,
    )
    minus_k = np.array([(-q) % nkp for q in range(nkp)], dtype=np.int32)
    hcore = []
    for _ in range(nkp):
        h = rng.standard_normal((nmo, nmo)) + 1j * rng.standard_normal(
            (nmo, nmo)
        )
        hcore.append(0.5 * (h + h.conj().T))
    chol = []
    for q in range(nkp):
        if minus_k[q] < q:
            # Hermiticity of the factorization: L^{-Q} = conj(L^Q)
            chol.append([c.conj() for c in chol[minus_k[q]]])
            continue
        cplx = 0.0 if minus_k[q] == q else 1.0
        # Self-inverse Q (Q = -Q + G) must have a real factor for the ERI
        # tensor to be Hermitian.
        lq = [
            rng.standard_normal((nmo * nmo, nchol))
            + cplx * 1j * rng.standard_normal((nmo * nmo, nchol))
            for _ in range(nkp)
        ]
        chol.append(lq)
    return hcore, chol, nmo_pk, nchol_pk, qk_k2, minus_k


@pytest.mark.unit
def test_kpoint_round_trip(tmp_path):
    hcore, chol, nmo_pk, nchol_pk, qk_k2, minus_k = synthetic_kpoint()
    fn = str(tmp_path / "kp.h5")
    hc.write_qmcpack_cholesky_kpoint(
        fn, hcore, chol, enuc=1.25, nelec=(3, 3), nmo_pk=nmo_pk,
        qk_k2=qk_k2, minus_k=minus_k, nchol_pk=nchol_pk,
    )
    (h2, c2, enuc, nmo_tot, nelec, nmo_pk2, qk2, nchol_pk2,
     minus_k2) = hc.read_qmcpack_cholesky_kpoint(fn)
    assert enuc == pytest.approx(1.25)
    assert nmo_tot == int(nmo_pk.sum())
    assert nelec == (3, 3)
    np.testing.assert_array_equal(nmo_pk2, nmo_pk)
    np.testing.assert_array_equal(qk2, qk_k2)
    np.testing.assert_array_equal(minus_k2, minus_k)
    for a, b in zip(h2, hcore):
        np.testing.assert_allclose(a, b, atol=1e-12)
    for q in range(len(chol)):
        want = np.stack([np.asarray(c).reshape(-1) for c in chol[q]])
        got = np.asarray(c2[q]).reshape(want.shape)
        np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.unit
def test_kpoint_supercell_assembly(tmp_path):
    """The dense supercell Cholesky must reproduce the k-point ERIs:
    (IK|JL) = sum_x A[I,K,x] conj(A[L,J,x])."""
    hcore, chol, nmo_pk, nchol_pk, qk_k2, minus_k = synthetic_kpoint(
        nkp=2, nmo=2, nchol=3
    )
    # Flatten per-Q lists into the [nkp, L] arrays the reader returns.
    chol_read = [
        np.stack([np.asarray(c).reshape(-1) for c in chol[q]])
        for q in range(len(chol))
    ]
    h1, a = hc.kpoint_to_supercell(hcore, chol_read, nmo_pk, qk_k2, nchol_pk)
    eri_ref = hc.kpoint_eri(chol_read, nmo_pk, qk_k2, nchol_pk)
    eri_dense = np.einsum("ikx,ljx->ikjl", a, a.conj(), optimize=True)
    np.testing.assert_allclose(eri_dense, eri_ref, atol=1e-10)
    m = int(nmo_pk.sum())
    assert h1.shape == (m, m)
    # The one-body part must be block-diagonal over k and Hermitian.
    np.testing.assert_allclose(h1, h1.conj().T, atol=1e-12)
    assert np.abs(h1[: nmo_pk[0], nmo_pk[0]:]).max() == 0.0
