"""LTI system classes (design/systems.py) vs scipy.signal's lti/dlti."""

import numpy as np
import pytest
import scipy.signal as ss

from simpledsp_jax.design.systems import (StateSpace, TransferFunction,
                                          ZerosPolesGain, dlti, lti)


def test_dispatch_and_conversions():
    s = lti([1.0, 2], [1, 2, 3])
    r = ss.lti([1.0, 2], [1, 2, 3])
    assert isinstance(s, TransferFunction) and s.dt is None
    np.testing.assert_allclose(s.num, r.num)
    np.testing.assert_allclose(s.den, r.den)
    np.testing.assert_allclose(np.sort_complex(s.poles),
                               np.sort_complex(r.poles), atol=1e-12)
    np.testing.assert_allclose(np.sort_complex(s.zeros),
                               np.sort_complex(r.zeros), atol=1e-12)
    z, rz = s.to_zpk(), r.to_zpk()
    assert isinstance(z, ZerosPolesGain)
    np.testing.assert_allclose(np.sort_complex(z.p),
                               np.sort_complex(rz.poles), atol=1e-12)
    assert abs(z.k - rz.gain) < 1e-12
    st, rst = s.to_ss(), r.to_ss()
    assert isinstance(st, StateSpace)
    np.testing.assert_allclose(st.A, rst.A, atol=1e-12)
    # zpk / ss argument dispatch + cross-class constructors
    assert isinstance(lti([-1.0], [-2.0, -3.0], 4.0), ZerosPolesGain)
    s4 = lti(st.A, st.B, st.C, st.D)
    assert isinstance(s4, StateSpace)
    np.testing.assert_allclose(np.sort_complex(s4.poles),
                               np.sort_complex(r.poles), atol=1e-10)
    assert isinstance(TransferFunction(z), TransferFunction)
    assert isinstance(ZerosPolesGain(s), ZerosPolesGain)
    assert isinstance(StateSpace(s), StateSpace)
    with pytest.raises(ValueError):
        lti([1.0])
    with pytest.raises(ValueError):
        dlti([1.0], [1.0], dt=None)


def test_continuous_responses_match_scipy():
    s = lti([1.0, 2], [1, 2, 3])
    r = ss.lti([1.0, 2], [1, 2, 3])
    T = np.linspace(0, 5, 200)
    np.testing.assert_allclose(s.impulse(T=T)[1], r.impulse(T=T)[1],
                               atol=1e-7)
    np.testing.assert_allclose(s.step(T=T)[1], r.step(T=T)[1], atol=1e-7)
    U = np.sin(T)
    np.testing.assert_allclose(s.output(U, T)[1], r.output(U, T)[1],
                               atol=1e-6)
    # X0: zero-input response added in the shared tf2ss coordinates
    np.testing.assert_allclose(s.output(U, T, X0=[0.5, -0.2])[1],
                               r.output(U, T, X0=[0.5, -0.2])[1],
                               atol=1e-6)
    w = np.logspace(-2, 2, 50)
    np.testing.assert_allclose(s.freqresp(w=w)[1], r.freqresp(w=w)[1],
                               atol=1e-12)
    _, m1, p1 = s.bode(w=w)
    _, m2, p2 = r.bode(w=w)
    np.testing.assert_allclose(m1, m2, atol=1e-10)
    np.testing.assert_allclose(p1, p2, atol=1e-8)
    # default grids reproduce scipy's pole-based heuristic
    w1, m1, _ = s.bode(n=30)
    w2, m2, _ = r.bode(n=30)
    np.testing.assert_allclose(w1, w2, atol=1e-10)
    np.testing.assert_allclose(m1, m2, atol=1e-8)


def test_discrete_responses_match_scipy():
    d = dlti([1.0, 0.5], [1, -0.5], dt=0.1)
    rd = ss.dlti([1.0, 0.5], [1, -0.5], dt=0.1)
    assert d.dt == 0.1
    t1, (y1,) = d.impulse(N=10)
    t2, y2 = rd.impulse(n=10)
    np.testing.assert_allclose(np.squeeze(y1), np.squeeze(y2[0]),
                               atol=1e-12)
    np.testing.assert_allclose(t1, t2, atol=1e-12)
    _, (y1,) = d.step(N=12)
    _, y2 = rd.step(n=12)
    np.testing.assert_allclose(np.squeeze(y1), np.squeeze(y2[0]),
                               atol=1e-12)
    u = np.sin(np.arange(20))
    _, y1 = d.output(u)
    _, y2 = rd.output(u, np.arange(20) * 0.1)[:2]
    np.testing.assert_allclose(np.squeeze(np.asarray(y1)),
                               np.squeeze(y2), atol=1e-10)
    # scipy conventions: freqresp w in rad/sample; bode returns w/dt
    w = np.linspace(0.05, 3.0, 40)
    w1, h1 = d.freqresp(w=w)
    w2, h2 = rd.freqresp(w=w)
    np.testing.assert_allclose(w1, w2, atol=1e-12)
    np.testing.assert_allclose(h1, h2, atol=1e-10)
    wb1, m1, p1 = d.bode(w=w)
    wb2, m2, p2 = rd.bode(w=w)
    np.testing.assert_allclose(wb1, wb2, atol=1e-10)
    np.testing.assert_allclose(m1, m2, atol=1e-8)
    np.testing.assert_allclose(p1, p2, atol=1e-8)
    # default grids agree too
    w1, h1 = d.freqresp(n=32)
    w2, h2 = rd.freqresp(n=32)
    np.testing.assert_allclose(w1, w2, atol=1e-12)
    np.testing.assert_allclose(h1, h2, atol=1e-10)


def test_to_discrete_matches_scipy():
    s = lti([1.0, 2], [1, 2, 3])
    r = ss.lti([1.0, 2], [1, 2, 3])
    for method in ("zoh", "bilinear"):
        sd = s.to_discrete(0.01, method=method)
        rsd = r.to_discrete(0.01, method=method)
        np.testing.assert_allclose(sd.num, np.squeeze(rsd.num), atol=1e-10)
        np.testing.assert_allclose(sd.den, rsd.den, atol=1e-10)
        assert sd.dt == 0.01
    with pytest.raises(ValueError):
        dlti([1.0], [1, -0.5], dt=0.1).to_discrete(0.1)
