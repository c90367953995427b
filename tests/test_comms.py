"""Digital modem family tests (models/comms.py).

Validation model: noiseless loopback must recover every bit exactly
(the communications analog of the reference's blockwise bit-exactness
contract, reference: test/testIIR.cpp:61-75), and measured AWGN BER must
track the analytic Q-function curve — the field's standard oracle.
"""

import numpy as np
import pytest
from scipy.special import erfc

import jax.numpy as jnp

from simpledsp_jax.design.fir import rrc_taps
from simpledsp_jax.models.comms import (Constellation, LinearModem, awgn,
                                        ber)


@pytest.mark.parametrize("const", ["bpsk", "qpsk", "qam16", "qam64"])
def test_constellation_energy_and_roundtrip(rng, const):
    c = {"bpsk": Constellation.bpsk, "qpsk": Constellation.qpsk,
         "qam16": lambda: Constellation.qam(16),
         "qam64": lambda: Constellation.qam(64)}[const]()
    assert abs(np.mean(np.sum(c.points ** 2, axis=1)) - 1.0) < 1e-12
    k = c.bits_per_symbol
    bits = jnp.asarray(rng.integers(0, 2, (3, (1200 // k) * k)))
    sr, si = c.map_bits(bits)
    assert bool(jnp.all(c.demap_hard(sr, si) == bits))


def test_gray_pam_adjacency():
    """Adjacent PAM levels differ in exactly one bit — the property that
    makes symbol errors cost one bit at high SNR."""
    for m in (1, 2, 3):
        levels = Constellation._gray_pam(m)
        order = np.argsort(levels)
        for a, b in zip(order[:-1], order[1:]):
            assert bin(int(a) ^ int(b)).count("1") == 1


def test_rrc_zero_isi_property():
    h = rrc_taps(8, 10, 0.35)
    assert h.size == 81
    assert abs(np.sum(h * h) - 1.0) < 1e-12
    rc = np.convolve(h, h)
    sym = rc[rc.size // 2 % 8::8]
    pk = np.argmax(np.abs(sym))
    assert abs(sym[pk] - 1.0) < 1e-9          # unity cascade gain
    isi = np.max(np.abs(np.delete(sym, pk)))
    assert 20.0 * np.log10(isi) < -40.0
    for bad in [dict(sps=8, span=10, beta=0.0),
                dict(sps=8, span=10, beta=1.5),
                dict(sps=0, span=10, beta=0.3),
                dict(sps=3, span=3, beta=0.3)]:   # odd span*sps
        with pytest.raises(ValueError):
            rrc_taps(**bad)


def test_noiseless_loopback_exact(rng):
    modem = LinearModem(Constellation.qam(16), sps=8, span=10, beta=0.35)
    nsym = 400
    bits = jnp.asarray(rng.integers(0, 2, (2, nsym * 4)))
    xr, xi = modem.modulate(bits)
    assert xr.shape == (2, nsym * 8)
    rx_bits, (sy_r, sy_i) = modem.demodulate(xr, xi)
    n_ok = (nsym - modem.delay_symbols) * 4
    assert rx_bits.shape == (2, n_ok)
    assert bool(jnp.all(rx_bits == bits[:, :n_ok]))
    # recovered symbols sit on the constellation to the ISI floor
    sref_r, sref_i = modem.constellation.map_bits(bits[:, :n_ok])
    evm = float(jnp.sqrt(jnp.mean((sy_r - sref_r) ** 2
                                  + (sy_i - sref_i) ** 2)))
    assert evm < 0.02


def test_qpsk_awgn_ber_tracks_theory(rng):
    """Measured BER within a statistical band of 0.5 erfc(sqrt(Eb/N0))."""
    modem = LinearModem(Constellation.qpsk(), sps=4, span=12, beta=0.3)
    nsym = 30000
    bits = jnp.asarray(rng.integers(0, 2, (nsym * 2,)))
    xr, xi = modem.modulate(bits)
    ebn0 = 4.0
    snr_db = ebn0 + 10.0 * np.log10(2) - 10.0 * np.log10(modem.sps)
    yr, yi = awgn(0, (xr, xi), snr_db, signal_power=1.0)
    rx, _ = modem.demodulate(yr, yi)
    n_ok = (nsym - modem.delay_symbols) * 2
    measured = float(ber(bits[:n_ok], rx[:n_ok]))
    theory = 0.5 * erfc(np.sqrt(10.0 ** (ebn0 / 10.0)))
    assert 0.6 * theory < measured < 1.6 * theory


def test_ber_shape_check():
    with pytest.raises(ValueError):
        ber(jnp.zeros(4), jnp.zeros(5))


class TestOFDM:
    def test_noiseless_loopback_exact(self, rng):
        from simpledsp_jax.models.comms import OFDMModem
        m = OFDMModem(Constellation.qam(16), n_fft=64, cp=16,
                      dtype=jnp.float64)
        bits = jnp.asarray(rng.integers(0, 2, (2, 20 * m.bits_per_symbol)))
        tr, ti = m.modulate(bits)
        assert tr.shape == (2, 20 * (64 + 16))
        rx, _ = m.demodulate(tr, ti)
        assert bool(jnp.all(rx == bits))

    def test_multipath_zero_forcing_exact(self, rng):
        """The OFDM claim itself: a multipath channel shorter than the
        cyclic prefix reduces to one complex scale per subcarrier, and
        zero-forcing equalization recovers every bit exactly."""
        from simpledsp_jax.models.comms import OFDMModem
        m = OFDMModem(Constellation.qam(16), n_fft=64, cp=16,
                      dtype=jnp.float64)
        bits = jnp.asarray(rng.integers(0, 2, (2, 12 * m.bits_per_symbol)))
        tr, ti = m.modulate(bits)
        h = np.array([1.0, 0.4 - 0.2j, -0.15 + 0.1j, 0.05j])
        tx = np.asarray(tr) + 1j * np.asarray(ti)
        rxs = np.stack([np.convolve(tx[i], h)[: tx.shape[1]]
                        for i in range(2)])
        rb, _ = m.demodulate(jnp.asarray(rxs.real), jnp.asarray(rxs.imag),
                             channel=(h.real, h.imag))
        assert bool(jnp.all(rb == bits))
        with pytest.raises(ValueError):
            m.demodulate(tr, ti, channel=(np.ones(40), np.zeros(40)))

    def test_qpsk_awgn_ber_tracks_theory(self, rng):
        from simpledsp_jax.models.comms import OFDMModem
        m = OFDMModem(Constellation.qpsk(), n_fft=64, cp=16,
                      dtype=jnp.float64)
        nsym = 300
        bits = jnp.asarray(rng.integers(0, 2, (nsym * m.bits_per_symbol,)))
        tr, ti = m.modulate(bits)
        ebn0 = 4.0
        snr_db = ebn0 + 10.0 * np.log10(2)    # unit power, Es = 1
        yr, yi = awgn(1, (tr, ti), snr_db, signal_power=1.0)
        rx, _ = m.demodulate(yr, yi)
        measured = float(ber(bits, rx))
        theory = 0.5 * erfc(np.sqrt(10.0 ** (ebn0 / 10.0)))
        assert 0.6 * theory < measured < 1.6 * theory

    def test_bad_args(self):
        from simpledsp_jax.models.comms import OFDMModem
        with pytest.raises(ValueError):
            OFDMModem(Constellation.qpsk(), n_fft=64, cp=64)
        m = OFDMModem(Constellation.qpsk(), n_fft=16, cp=4)
        with pytest.raises(ValueError):
            m.modulate(jnp.zeros(33, jnp.int32))
        with pytest.raises(ValueError):
            m.demodulate(jnp.zeros(10), jnp.zeros(10))


def test_ofdm_channel_validates_both_planes():
    from simpledsp_jax.models.comms import OFDMModem
    m = OFDMModem(Constellation.qpsk(), n_fft=64, cp=16)
    bits = jnp.zeros(2 * m.bits_per_symbol, jnp.int32)
    tr, ti = m.modulate(bits)
    with pytest.raises(ValueError, match="cyclic prefix"):
        m.demodulate(tr, ti, channel=(np.ones(3), np.zeros(40)))
