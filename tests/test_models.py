"""Flagship-model tests: NorthStarChain (serial + sharded) on CPU.

The chain is validated against the scipy+numpy oracle and the sharded form
against the serial one; chip_smoke.py repeats both checks on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig

from simpledsp_jax.design.biquad import sos_matrix
from simpledsp_jax.models.northstar import (
    NorthStarChain,
    ShardedNorthStarChain,
    default_design,
)
from simpledsp_jax.parallel import make_mesh


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(dp=2, sp=4)


def _oracle_spectra(design, x):
    """Packed one-sided oracle: scipy sosfilt (f64) + numpy rfft, packed to
    the chain's N/2-bin halfcomplex layout (Nyquist.re in imag bin 0)."""
    y = sig.sosfilt(sos_matrix(design), np.asarray(x, np.float64), axis=-1)
    full = np.fft.rfft(y.reshape(x.shape[0], -1, 4096))
    pr = full.real[..., :-1]
    pi = np.concatenate([full.real[..., -1:], full.imag[..., 1:-1]], axis=-1)
    return pr + 1j * pi


class TestNorthStarChain:
    def test_matches_oracle_f64(self, rng):
        chain = NorthStarChain(dtype=jnp.float64)
        x = rng.standard_normal((2, 16384))
        (sr, si), state = chain(jnp.asarray(x))
        ref = _oracle_spectra(chain.design, x)
        got = np.asarray(sr) + 1j * np.asarray(si)
        assert got.shape == ref.shape == (2, 4, 2048)
        assert np.abs(got - ref).max() < 1e-9

    def test_unpack_matches_numpy_rfft(self, rng):
        """unpack_rfft_ri on the chain output == numpy rfft of the
        filtered signal (the pure N/2+1 one-sided form)."""
        from simpledsp_jax.ops.fft import unpack_rfft_ri
        chain = NorthStarChain(dtype=jnp.float64)
        x = rng.standard_normal((1, 8192))
        (sr, si), _ = chain(jnp.asarray(x))
        yr, yi = unpack_rfft_ri(sr, si)
        y = sig.sosfilt(sos_matrix(chain.design), x.astype(np.float64),
                        axis=-1)
        ref = np.fft.rfft(y.reshape(1, -1, 4096))
        got = np.asarray(yr) + 1j * np.asarray(yi)
        assert got.shape == ref.shape == (1, 2, 2049)
        assert np.abs(got - ref).max() < 1e-9

    def test_streaming_state(self, rng):
        chain = NorthStarChain(dtype=jnp.float64)
        x = rng.standard_normal((1, 16384))
        (ar, ai), _ = chain(jnp.asarray(x))
        (br, bi), s = chain(jnp.asarray(x[:, :8192]))
        (cr, ci), _ = chain(jnp.asarray(x[:, 8192:]), s)
        np.testing.assert_allclose(
            np.concatenate([np.asarray(br), np.asarray(cr)], axis=1),
            np.asarray(ar), atol=1e-10)

    def test_bad_length_raises(self):
        chain = NorthStarChain()
        with pytest.raises(ValueError):
            chain(jnp.zeros((1, 5000)))


class TestShardedNorthStarChain:
    def test_matches_serial(self, mesh, rng):
        design = default_design()
        serial = NorthStarChain(design=design, dtype=jnp.float64)
        sharded = ShardedNorthStarChain(mesh, design=design,
                                        dtype=jnp.float64)
        x = rng.standard_normal((2, 4 * 16384))
        (ar, ai), s_a = serial(jnp.asarray(x))
        (br, bi), s_b = sharded(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(br), np.asarray(ar), atol=1e-9)
        np.testing.assert_allclose(np.asarray(s_b.y_hist),
                                   np.asarray(s_a.y_hist), atol=1e-10)

    def test_streaming_sharded(self, mesh, rng):
        sharded = ShardedNorthStarChain(mesh, dtype=jnp.float64)
        x = rng.standard_normal((2, 8 * 16384))
        (ar, _), _ = sharded(jnp.asarray(x))
        (br, _), s = sharded(jnp.asarray(x[:, :4 * 16384]))
        (cr, _), _ = sharded(jnp.asarray(x[:, 4 * 16384:]), s)
        np.testing.assert_allclose(
            np.concatenate([np.asarray(br), np.asarray(cr)], axis=1),
            np.asarray(ar), atol=1e-10)


class TestStreamingSoak:
    def test_long_stream_stability(self, rng):
        """200 chained blocks: state stays bounded, outputs finite, and a
        mid-stream block equals the same block from a fresh whole-run —
        the streaming contract under sustained use."""
        chain = NorthStarChain(dtype=jnp.float64)
        nblk, blk = 200, 4096
        x = rng.standard_normal((1, nblk * blk))
        state = None
        outs = []
        for i in range(nblk):
            (sr, si), state = chain(jnp.asarray(x[:, i*blk:(i+1)*blk]), state)
            outs.append((np.asarray(sr), np.asarray(si)))
        assert all(np.isfinite(a).all() and np.isfinite(b).all()
                   for a, b in outs)
        # state bounded (stable filter, bounded input)
        assert np.abs(np.asarray(state.y_hist)).max() < 100.0
        # block 150 from streaming == block 150 from a single whole run
        (ar, ai), _ = chain(jnp.asarray(x))
        np.testing.assert_allclose(outs[150][0][0, 0],
                                   np.asarray(ar)[0, 150], atol=1e-9)
