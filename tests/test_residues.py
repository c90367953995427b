"""Partial-fraction family vs scipy.signal (design/residues.py)."""

import numpy as np
import pytest
import scipy.signal as ss

from simpledsp_jax.design import residues as rz


def _cmp_sets(r1, p1, r2, p2, atol=1e-8):
    r1, p1, r2, p2 = map(np.asarray, (r1, p1, r2, p2))
    i1 = np.lexsort((np.abs(r1), p1.real, p1.imag))
    i2 = np.lexsort((np.abs(r2), p2.real, p2.imag))
    np.testing.assert_allclose(p1[i1], p2[i2], atol=atol)
    np.testing.assert_allclose(r1[i1], r2[i2], atol=atol)


def _ratval(b, a, x, zinv=False):
    b, a = np.asarray(b, complex), np.asarray(a, complex)
    if zinv:
        u = 1.0 / x
        return (sum(c * u ** i for i, c in enumerate(b))
                / sum(c * u ** i for i, c in enumerate(a)))
    return np.polyval(b, x) / np.polyval(a, x)


def test_unique_roots_matches_scipy():
    p = np.array([1.0, 1.0002, 2.5, 2.5, -3.0])
    u1, m1 = rz.unique_roots(p, tol=1e-3)
    u2, m2 = ss.unique_roots(p, tol=1e-3)
    np.testing.assert_allclose(np.sort(u1), np.sort(u2))
    assert sorted(m1) == sorted(m2)
    with pytest.raises(ValueError):
        rz.unique_roots(p, rtype="median")


def test_residue_simple_and_improper():
    a = np.poly([-1.0, -2.5, -4.0])
    b = np.array([1.0, 2.0, 3.0])
    r1, p1, k1 = rz.residue(b, a)
    r2, p2, k2 = ss.residue(b, a)
    _cmp_sets(r1, p1, r2, p2)
    b2 = np.polyadd(np.polymul([2.0, 1.0], a), np.array([1.0, 0.5, 0.2]))
    r1, p1, k1 = rz.residue(b2, a)
    r2, p2, k2 = ss.residue(b2, a)
    _cmp_sets(r1, p1, r2, p2)
    np.testing.assert_allclose(k1, k2)


def test_residue_repeated_and_invres_round_trip():
    a = np.polymul(np.poly([-1.0, -1.0]), [1.0, 3.0])
    b = np.array([1.0, 0.5, 2.0])
    r1, p1, k1 = rz.residue(b, a)
    r2, p2, k2 = ss.residue(b, a)
    _cmp_sets(r1, p1, r2, p2)
    bb, aa = rz.invres(r1, p1, k1)
    for x in (2.0, -0.3 + 1.1j):
        assert abs(_ratval(bb, aa, x) - _ratval(b, a, x)) < 1e-9


def test_residuez_cases_and_invresz_round_trip():
    az = np.array([1.0, -0.2, -0.15])
    for bz in (np.array([1.0, -0.5]),
               np.array([2.0, 1.0, 0.3, -0.1])):       # proper + improper
        r1, p1, k1 = rz.residuez(bz, az)
        r2, p2, k2 = ss.residuez(bz, az)
        _cmp_sets(r1, p1, r2, p2)
        np.testing.assert_allclose(np.asarray(k1), np.asarray(k2),
                                   atol=1e-10)
        bb, aa = rz.invresz(r1, p1, k1)
        for x in (1.7 + 0.3j, -2.2):
            assert abs(_ratval(bb, aa, x, zinv=True)
                       - _ratval(bz, az, x, zinv=True)) < 1e-9


def test_residuez_repeated_pole():
    az = np.polymul([1.0, -0.5], np.polymul([1.0, -0.5], [1.0, 0.3]))
    bz = np.array([1.0, 0.2])
    r1, p1, k1 = rz.residuez(bz, az)
    r2, p2, k2 = ss.residuez(bz, az)
    _cmp_sets(r1, p1, r2, p2)
    bb, aa = rz.invresz(r1, p1, k1)
    assert abs(_ratval(bb, aa, 1.9, zinv=True)
               - _ratval(bz, az, 1.9, zinv=True)) < 1e-9


def test_residue_rejects_zero_denominator():
    with pytest.raises(ValueError):
        rz.residue([1.0], [0.0])
