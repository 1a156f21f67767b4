"""Native C++ FCIDUMP loader vs the pure-Python behavioural oracle.

The native parser (pauxy_jax/native/fcidump.cpp, ctypes) must reproduce
utils/qmcpack.read_fcidump exactly on both real and complex files
(reference format: pauxy/utils/hamiltonian_converter.py:8-100, 295-360).
"""

import numpy as np
import pytest

from pauxy_jax import native
from pauxy_jax.utils import qmcpack


def _write_fcidump(path, norb, nelec, ms2, entries, cplx):
    with open(path, "w") as f:
        f.write(f"&FCI NORB={norb},NELEC={nelec},MS2={ms2},\n")
        f.write("ORBSYM=" + "1," * norb + "\n&END\n")
        for v, i, j, k, l in entries:
            if cplx:
                f.write(f"({v.real:.16e}, {v.imag:.16e}) {i} {j} {k} {l}\n")
            else:
                f.write(f"{v:.16e} {i} {j} {k} {l}\n")


def _make_entries(norb, cplx, seed):
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(1, norb + 1):
        for j in range(1, i + 1):
            v = rng.normal() + (1j * rng.normal() if cplx and i != j else 0)
            entries.append((v, i, j, 0, 0))
    for _ in range(4 * norb):
        i, j, k, l = rng.integers(1, norb + 1, size=4)
        entries.append((rng.normal() + 0j if cplx else rng.normal(),
                        int(i), int(j), int(k), int(l)))
    entries.append((0.7137 + 0j if cplx else 0.7137, 0, 0, 0, 0))
    return entries


@pytest.mark.unit
@pytest.mark.parametrize("cplx", [False, True])
def test_native_matches_python_oracle(tmp_path, monkeypatch, cplx):
    if not native.available():
        pytest.skip(f"native loader unavailable: {native.load_error()}")
    norb = 5
    path = str(tmp_path / "FCIDUMP")
    _write_fcidump(path, norb, 6, 0, _make_entries(norb, cplx, 3), cplx)

    h1_n, eri_n, ec_n, nelec_n, ms2_n = qmcpack.read_fcidump(path)
    # Force the pure-Python path for the oracle parse.
    monkeypatch.setattr(native, "fcidump_fill", lambda *a: None)
    h1_p, eri_p, ec_p, nelec_p, ms2_p = qmcpack.read_fcidump(path)

    np.testing.assert_array_equal(h1_n, h1_p)
    np.testing.assert_array_equal(eri_n, eri_p)
    assert ec_n == ec_p and nelec_n == nelec_p and ms2_n == ms2_p
    assert np.iscomplexobj(h1_n) == cplx


@pytest.mark.unit
def test_malformed_body_falls_back(tmp_path):
    """A body the strict native parser rejects must still load through the
    permissive Python parser (which skips junk lines)."""
    norb = 3
    path = str(tmp_path / "FCIDUMP")
    with open(path, "w") as f:
        f.write(f"&FCI NORB={norb},NELEC=2,MS2=0,\n&END\n")
        f.write("this line is junk\n")
        f.write("1.5 1 1 0 0\n")
        f.write("0.25 0 0 0 0\n")
    h1, eri, ec, nelec, _ = qmcpack.read_fcidump(path)
    assert h1[0, 0] == 1.5 and ec == 0.25 and nelec == (1, 1)


@pytest.mark.unit
def test_fallback_warns_with_offset(tmp_path):
    """The silent-fallback path must be loud: a body the native parser
    rejects triggers a warning naming the failure before the permissive
    retry (ADVICE r3)."""
    if not native.available():
        pytest.skip(f"native loader unavailable: {native.load_error()}")
    norb = 3
    path = str(tmp_path / "FCIDUMP")
    with open(path, "w") as f:
        f.write(f"&FCI NORB={norb},NELEC=2,MS2=0,\n&END\n")
        f.write("junk\n1.5 1 1 0 0\n")
    with pytest.warns(UserWarning, match="permissive Python parser"):
        h1, _, _, _, _ = qmcpack.read_fcidump(path)
    assert h1[0, 0] == 1.5


@pytest.mark.unit
@pytest.mark.parametrize(
    "entry",
    [
        "1.0 4 1 1 1\n",      # index > norb
        "1.0 -2 1 1 1\n",     # negative index
        "1.0 99 99 0 0\n",    # one-body out of range
        "1.0 1 0 1 1\n",      # zero inside a two-body entry
        "1.0 0 1 0 0\n",      # zero inside a one-body entry
    ],
)
def test_native_rejects_bad_indices(entry):
    """Orbital indices outside [1, norb] (or invalid zero patterns) must
    raise, never write out of bounds of the caller's arrays (ADVICE r3
    high-severity finding)."""
    if not native.available():
        pytest.skip(f"native loader unavailable: {native.load_error()}")
    body = ("0.5 1 1 0 0\n" + entry).encode()
    with pytest.raises(ValueError, match="byte"):
        native.fcidump_fill(body, 3, False)


@pytest.mark.unit
def test_native_parse_locale_independent(tmp_path):
    """Parsing must not follow LC_NUMERIC (ADVICE r3: a comma-decimal
    locale silently disabled the native fast path)."""
    import ctypes
    import ctypes.util
    import locale

    if not native.available():
        pytest.skip(f"native loader unavailable: {native.load_error()}")
    # Python's locale.setlocale does not affect the C library's LC_NUMERIC
    # as seen by the .so reliably across platforms; set it via libc too.
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    target = None
    for cand in ("de_DE.UTF-8", "fr_FR.UTF-8", "de_DE", "fr_FR"):
        if libc.setlocale(1, cand.encode()):  # 1 == LC_NUMERIC (glibc)
            target = cand
            break
    if target is None:
        pytest.skip("no comma-decimal locale available in this image")
    try:
        res = native.fcidump_fill(b"2.5 1 1 0 0\n", 2, False)
        assert res is not None
        h1, _, _ = res
        assert h1[0, 0] == 2.5  # strtod under de_DE would stop at the '.'
    finally:
        libc.setlocale(1, b"C")
        locale.setlocale(locale.LC_ALL, "C")


@pytest.mark.unit
def test_no_native_env_disables(tmp_path, monkeypatch):
    """PAUXY_NO_NATIVE short-circuits the loader (fresh module state)."""
    import importlib

    monkeypatch.setenv("PAUXY_NO_NATIVE", "1")
    mod = importlib.reload(native)
    try:
        assert not mod.available()
        assert "disabled" in (mod.load_error() or "")
    finally:
        monkeypatch.delenv("PAUXY_NO_NATIVE")
        importlib.reload(native)
