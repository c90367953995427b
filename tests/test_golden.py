"""Golden-fixture regression tests against the COMMITTED CSV set.

This is the framework's version of the reference's directory-iterating
fixture test (reference: test/testIIR.cpp:30-75): read every CSV in
test_data/impulse_response, rebuild the filter from the header metadata,
and require the impulse response to match to 1e-12 — plus the blockwise
bit-exactness check on the same data.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from simpledsp_jax.design.biquad import (
    FilterType,
    design_bandpass,
    design_highpass,
    design_lowpass,
)
from simpledsp_jax.ops.iir import coeffs_from_design, iir_init, sosfilt_scan
from simpledsp_jax.utils.fixtures import read_fixture

FIXTURE_DIR = (pathlib.Path(__file__).parent.parent
               / "test_data" / "impulse_response")
FIXTURES = sorted(FIXTURE_DIR.glob("*.csv"))


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_impulse_response_matches_fixture(path):
    fx = read_fixture(path)
    m = 4  # order 8 = 4 SOS, the fixture generation setting
    if fx.ftype == FilterType.low_pass:
        design = design_lowpass(m, fx.f0, fx.fs)
    elif fx.ftype == FilterType.high_pass:
        design = design_highpass(m, fx.f0, fx.fs)
    elif fx.ftype == FilterType.band_pass:
        design = design_bandpass(m, fx.f0, fx.fs, fx.q)
    else:
        pytest.skip(f"no fixture type {fx.ftype}")

    n = fx.response.size
    x = np.zeros(n)
    x[0] = 1.0
    coeffs = coeffs_from_design(design, dtype=jnp.float64)
    y, _ = sosfilt_scan(coeffs, jnp.asarray(x),
                        iir_init(m, (), dtype=jnp.float64))
    err = np.abs(np.asarray(y) - fx.response).max()
    # the reference's acceptance gate (testIIR.cpp:59)
    assert err < 1e-12, f"{path.name}: {err:.2e}"

    # blockwise == whole, bit-exact (testIIR.cpp:61-75), 32-sample blocks
    state = iir_init(m, (), dtype=jnp.float64)
    parts = []
    for i in range(0, n, 32):
        yb, state = sosfilt_scan(coeffs, jnp.asarray(x[i:i + 32]), state)
        parts.append(np.asarray(yb))
    assert np.array_equal(np.concatenate(parts), np.asarray(y))


def test_fixture_set_is_complete():
    assert len(FIXTURES) == 9  # LP/HP/BP x 3 (f0, Q) cases
