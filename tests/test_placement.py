"""Pole placement (design/placement.py) vs scipy.signal.place_poles.

The gain matrix is NOT unique for MIMO systems, so parity is asserted
on what is well-defined: the achieved closed-loop poles (machine
precision), the robustness indicator |det(X)| (matches scipy's to ~1e-3
— both implement the same published KNV0/YT optimizations), realness of
K, and the validation/raise surface.
"""

import warnings

import numpy as np
import pytest
import scipy.signal as ss

from simpledsp_jax.design.placement import place_poles

A_DOC = np.array([[1.380, -0.2077, 6.715, -5.676],
                  [-0.5814, -4.290, 0, 0.6750],
                  [1.067, 4.273, -6.654, 5.893],
                  [0.0480, 4.273, 1.343, -2.104]])
B_DOC = np.array([[0, 5.679], [1.136, 1.136], [0, 0], [-3.146, 0]])


def _check(A, B, poles, method="YT"):
    A, B = np.asarray(A, float), np.asarray(B, float)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fsf = place_poles(A, B, poles, method=method)
        ref = ss.place_poles(A, B, poles, method=method)
    req = np.sort_complex(np.asarray(fsf.requested_poles))
    got = np.sort_complex(np.asarray(fsf.computed_poles))
    err = np.max(np.abs(got - req))
    ref_err = np.max(np.abs(
        np.sort_complex(np.asarray(ref.computed_poles)) - req))
    assert err < 1e-6 or err <= 10 * max(ref_err, 1e-8)
    assert np.isrealobj(fsf.gain_matrix)
    # same closed-loop conditioning as scipy's optimizer
    np.testing.assert_allclose(abs(np.linalg.det(fsf.X)),
                               abs(np.linalg.det(ref.X)), rtol=0.05)
    # the record carries the scipy Bunch surface
    for field in ("gain_matrix", "computed_poles", "requested_poles",
                  "X", "rtol", "nb_iter"):
        assert hasattr(fsf, field)
    return fsf


def test_mimo_real_and_complex_poles():
    _check(A_DOC, B_DOC, np.array([-0.2, -0.5, -5.0566, -8.6659]))
    _check(A_DOC, B_DOC, np.array([-0.2, -0.5, -5.0566, -8.6659]),
           method="KNV0")
    _check(A_DOC, B_DOC,
           np.array([-0.2 + 0.5j, -0.2 - 0.5j, -5.0, -8.0]))


def test_siso_and_square_B():
    fsf = _check([[0, 1], [0, 0]], [[0], [1]], [-2.0, -3.0])
    assert fsf.nb_iter == 0 and fsf.rtol == 0     # rank-1 B: nothing to opt
    fsf = _check(np.diag([1.0, 2.0, 3.0]), np.eye(3),
                 [-1.0, -2.0, -3.0])
    assert np.isnan(fsf.rtol) and np.isnan(fsf.nb_iter)
    _check(np.diag([1.0, 2.0, 3.0]), np.eye(3),
           [-1.0 + 1j, -1.0 - 1j, -3.0])


def test_random_mimo_grid():
    rng = np.random.default_rng(0)
    for _ in range(3):
        A = rng.standard_normal((5, 5))
        B = rng.standard_normal((5, 3))
        _check(A, B, -np.abs(rng.uniform(0.5, 4.0, 5)))
        _check(A, B, -np.abs(rng.uniform(0.5, 4.0, 5)), method="KNV0")
        _check(A, B, np.array([-1.0 + 1j, -1.0 - 1j, -2.0 + 0.5j,
                               -2.0 - 0.5j, -3.0]))


def test_validation_matches_scipy():
    A2, B2 = [[0, 1], [0, 0]], [[0], [1]]
    with pytest.raises(ValueError):
        place_poles(A2, B2, [-1.0 + 1j, -2.0])       # unpaired complex
    with pytest.raises(ValueError):
        place_poles(A2, B2, [-1.0 + 1j, -1.0 - 1j], method="KNV0")
    with pytest.raises(ValueError):
        place_poles(A2, B2, [-1.0, -2.0, -3.0])      # pole count
    with pytest.raises(ValueError):
        place_poles(A2, B2, [-1.0, -1.0])            # multiplicity > rank B
    with pytest.raises(ValueError):
        place_poles(A2, B2, [-1.0, -2.0], method="nope")
    with pytest.raises(ValueError):
        place_poles(A2, B2, [-1.0, -2.0], maxiter=0)
    with pytest.raises(ValueError):
        place_poles(A2, B2, [-1.0, -2.0], rtol=2.0)
