"""Production pyscf->AFQMC pipeline pieces, tested without pyscf.

The chunked Cholesky is validated against the dense-ERI factorization; the
shell-slice access pattern is exercised with a mock ``mol`` exposing the
pyscf integral surface (``nao_nr``/``nbas``/``bas_angular``/``bas_nctr``/
``intor(shls_slice=...)``) backed by a synthetic PSD tensor.

Reference behaviors: ``pauxy/utils/from_pyscf.py:286-394`` (chunked
Cholesky), ``:395-550`` (out-of-core), ``:552-610`` (CASSCF multi-det
export), ``:67-123`` (write_wfn_mol).
"""

import numpy as np
import pytest

from pauxy_jax.utils.from_pyscf import (
    DenseERIProvider,
    PyscfShellProvider,
    chunked_cholesky,
    chunked_cholesky_outcore,
    gen_occ_lists,
    multi_det_wavefunction,
    read_multi_det_file,
    write_wfn_mol,
)


def synthetic_eri(nao: int, seed: int = 3, rank: int | None = None):
    """Random PSD 'ERI' with 8-fold-symmetric index structure: build
    L[(pq), x] symmetric in p<->q, M = L L^T, reshape to (pq|rs)."""
    rng = np.random.default_rng(seed)
    rank = rank or 2 * nao
    L = rng.normal(size=(nao, nao, rank)) / nao
    L = 0.5 * (L + L.transpose(1, 0, 2))
    m = np.einsum("pqx,rsx->pqrs", L, L)
    return m


class MockMol:
    """Duck-typed pyscf mol: shells of sizes [1, 3, 2, ...] over a dense
    backing ERI; intor supports exactly the two shls_slice patterns the
    provider uses."""

    def __init__(self, eri, shell_sizes):
        self.eri = eri
        self.sizes = list(shell_sizes)
        assert sum(self.sizes) == eri.shape[0]
        self.offs = np.concatenate([[0], np.cumsum(self.sizes)])

    def nao_nr(self):
        return self.eri.shape[0]

    @property
    def nbas(self):
        return len(self.sizes)

    def bas_angular(self, i):
        # Encode the shell size as 2l+1 (nctr=1): size 1 -> l=0, 3 -> l=1...
        assert self.sizes[i] % 2 == 1, "mock uses odd shell sizes"
        return (self.sizes[i] - 1) // 2

    def bas_nctr(self, i):
        return 1

    def intor(self, name, shls_slice=None):
        assert name == "int2e_sph" and shls_slice is not None
        i0, i1, j0, j1, k0, k1, l0, l1 = shls_slice
        sl = lambda a, b: slice(self.offs[a], self.offs[b])  # noqa: E731
        return np.ascontiguousarray(
            self.eri[sl(i0, i1), sl(j0, j1), sl(k0, k1), sl(l0, l1)]
        )


def test_chunked_cholesky_reconstructs_eri():
    eri = synthetic_eri(6)
    chol = chunked_cholesky(DenseERIProvider(eri), max_error=1e-10)
    m = chol.T @ chol
    np.testing.assert_allclose(m, eri.reshape(36, 36), atol=1e-8)


def test_chunked_cholesky_accepts_dense_tensor():
    eri = synthetic_eri(5, seed=11)
    chol = chunked_cholesky(eri, max_error=1e-9)
    np.testing.assert_allclose(chol.T @ chol, eri.reshape(25, 25), atol=1e-7)


def test_shell_provider_matches_dense():
    """The shell-slice indexing (searchsorted offsets, in-shell AO index)
    must address exactly the same columns as the dense tensor."""
    eri = synthetic_eri(6, seed=7)
    mol = MockMol(eri, [1, 3, 1, 1])
    p = PyscfShellProvider(mol)
    d = DenseERIProvider(eri)
    np.testing.assert_allclose(p.diagonal(), d.diagonal(), atol=1e-14)
    for j, l in [(0, 0), (1, 3), (3, 1), (5, 5), (2, 4)]:
        np.testing.assert_allclose(
            p.column(j, l), d.column(j, l), atol=1e-14, err_msg=f"({j},{l})"
        )


def test_chunked_cholesky_via_mock_mol():
    """End-to-end through the mol.intor access path, never touching the
    dense tensor inside the factorization."""
    eri = synthetic_eri(6, seed=5)
    mol = MockMol(eri, [3, 1, 1, 1])
    chol = chunked_cholesky(mol, max_error=1e-10)
    np.testing.assert_allclose(chol.T @ chol, eri.reshape(36, 36), atol=1e-8)


def test_outcore_matches_incore(tmp_path):
    eri = synthetic_eri(6, seed=9)
    incore = chunked_cholesky(eri, max_error=1e-9)
    f = str(tmp_path / "chol.h5")
    n = chunked_cholesky_outcore(eri, f, max_error=1e-9, chunk_rows=3)
    import h5py

    with h5py.File(f) as fh5:
        outcore = fh5["chol_outcore"][:]
    assert n == incore.shape[0]
    np.testing.assert_allclose(outcore, incore, atol=1e-12)


def test_gen_occ_lists_cistring_order():
    """pyscf cistring order = determinant bitstrings ascending as ints:
    norb=4, nelec=2 -> ints 3,5,6,9,10,12."""
    occ = gen_occ_lists(4, 2)
    ints = [sum(1 << o for o in row) for row in occ]
    assert ints == [3, 5, 6, 9, 10, 12]
    assert ints == sorted(ints)


class MockMC:
    """Duck-typed CASCI solver result."""

    def __init__(self, ncas, nelecas, ncore, ci):
        self.ncas = ncas
        self.nelecas = nelecas
        self.ncore = ncore
        self.ci = ci


def test_multi_det_roundtrip(tmp_path):
    """CASSCF export -> occ file -> parsed coeffs/occupations feed
    phmsd_trial."""
    ncas, ne = 4, (2, 2)
    nd = len(gen_occ_lists(ncas, 2))
    rng = np.random.default_rng(2)
    ci = rng.normal(size=(nd, nd))
    ci /= np.linalg.norm(ci)
    mc = MockMC(ncas, ne, ncore=1, ci=ci)
    f = str(tmp_path / "multi_det.dat")
    multi_det_wavefunction(mc, weight_cutoff=0.9, filename=f)

    coeffs, occa, occb = read_multi_det_file(f)
    assert len(coeffs) >= 1
    # Coefficients sorted by decreasing |c| and match the CI tensor entries.
    assert (np.abs(coeffs)[:-1] >= np.abs(coeffs)[1:] - 1e-12).all()
    occl = gen_occ_lists(ncas, 2)
    key = {tuple(row): i for i, row in enumerate(occl)}
    norb = ncas + mc.ncore
    for c, oa, ob in zip(coeffs, occa, occb):
        # Strip the core orbital (index 0 up / norb down after unshift).
        assert oa[0] == 0 and ob[0] == 0
        ia = key[tuple(x - mc.ncore for x in oa[1:])]
        ib = key[tuple(x - mc.ncore for x in ob[1:])]
        assert ci[ia, ib] == pytest.approx(c, abs=1e-12)
    # Accumulated weight reaches the cutoff.
    assert (coeffs ** 2).sum() >= 0.9 - 1e-12


def test_multi_det_feeds_phmsd_trial(tmp_path):
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.multi_slater import phmsd_trial
    from pauxy_jax.utils.testing import generate_hamiltonian

    ncas = 4
    nd = len(gen_occ_lists(ncas, 2))
    rng = np.random.default_rng(4)
    ci = rng.normal(size=(nd, nd))
    ci /= np.linalg.norm(ci)
    mc = MockMC(ncas, (2, 2), ncore=0, ci=ci)
    f = str(tmp_path / "md.dat")
    multi_det_wavefunction(mc, weight_cutoff=0.5, filename=f)
    coeffs, occa, occb = read_multi_det_file(f)

    h1e, chol, enuc, _ = generate_hamiltonian(ncas, (2, 2), seed=5, nchol=8)
    ham = make_generic((2, 2), h1e, chol, enuc)
    trial = phmsd_trial(ham, coeffs, occa, occb)
    assert trial.psia.shape[0] == len(coeffs)


def test_write_wfn_mol_rhf_roundtrip(tmp_path):
    from pauxy_jax.utils.wavefunction import read_orbitals

    rng = np.random.default_rng(1)
    norb, na, nb = 6, 3, 3
    C = rng.normal(size=(norb, norb))
    X = np.eye(norb)
    f = str(tmp_path / "wfn.h5")
    scf_data = {"mo_coeff": C, "X": X, "isUHF": False, "nelec": (na, nb)}
    write_wfn_mol(scf_data, ortho_ao=True, filename=f)
    psi, coeffs = read_orbitals(f)
    assert psi.shape == (1, norb, na + nb)
    np.testing.assert_allclose(coeffs, [1.0 + 0j])
    np.testing.assert_allclose(psi[0, :, :na].real, C[:, :na], atol=1e-12)


def test_write_wfn_mol_uhf(tmp_path):
    from pauxy_jax.utils.wavefunction import read_orbitals

    rng = np.random.default_rng(8)
    norb, na, nb = 5, 3, 2
    C = rng.normal(size=(2, norb, norb))
    # Non-trivial orthogonalizer: psi = X^-1 C.
    X = np.eye(norb) + 0.1 * rng.normal(size=(norb, norb))
    f = str(tmp_path / "wfnu.h5")
    scf_data = {"mo_coeff": C, "X": X, "isUHF": True, "nelec": (na, nb)}
    write_wfn_mol(scf_data, ortho_ao=True, filename=f)
    psi, _ = read_orbitals(f)
    xinv = np.linalg.inv(X)
    np.testing.assert_allclose(psi[0, :, :na].real, (xinv @ C[0])[:, :na],
                               atol=1e-12)
    np.testing.assert_allclose(psi[0, :, na:].real, (xinv @ C[1])[:, :nb],
                               atol=1e-12)


def test_write_qmcpack_wfn_many_dets(tmp_path):
    """Numeric PsiT ordering survives D > 10 (lexicographic sort would
    interleave PsiT_10 before PsiT_2)."""
    from pauxy_jax.utils.wavefunction import read_orbitals, write_qmcpack_wfn

    rng = np.random.default_rng(3)
    D, norb, na, nb = 12, 4, 2, 2
    wfn = rng.normal(size=(D, norb, na + nb)) + 0j
    coeffs = rng.normal(size=D) + 0j
    f = str(tmp_path / "msd.h5")
    write_qmcpack_wfn(f, coeffs, wfn, (na, nb))
    psi, c = read_orbitals(f)
    np.testing.assert_allclose(c, coeffs)
    np.testing.assert_allclose(psi, wfn, atol=1e-14)


def test_multi_det_norb_header_disambiguates(tmp_path):
    """With norb > occupied range (top orbitals empty in every kept
    determinant) the (max+1)//2 inference is wrong; the NORB header our
    writer emits must make the up/down split exact (code-review r3)."""
    ncas, ne = 3, (1, 1)
    nd = len(gen_occ_lists(ncas, 1))
    rng = np.random.default_rng(7)
    ci = rng.normal(size=(nd, nd))
    ci /= np.linalg.norm(ci)
    mc = MockMC(ncas, ne, ncore=0, ci=ci)
    f = str(tmp_path / "md_norb.dat")
    # norb=6: down-spin indices start at 6 but only active orbitals 0-2
    # appear, so occ.max() is small and the old guess mis-split.
    multi_det_wavefunction(mc, weight_cutoff=0.999, filename=f, norb=6)
    coeffs, occa, occb = read_multi_det_file(f)
    assert occa.shape[1] == 1 and occb.shape[1] == 1
    assert (occa < 3).all() and (occb < 3).all() and (occb >= 0).all()
    # Explicit-argument path matches the header path.
    c2, oa2, ob2 = read_multi_det_file(f, norb=6)
    np.testing.assert_array_equal(occa, oa2)
    np.testing.assert_array_equal(occb, ob2)
