"""The plain XLA north-star chain at every FFT size it is run at, streamed
in one call or split across calls, against the float64 scipy oracle
(models/reference.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simpledsp_jax.models.northstar import NorthStarChain
from simpledsp_jax.models.reference import chain_spectra, snr_db

# Frames per call: one call, two equal calls, and an uneven 1 + 3 split.
SPLITS = {"whole": (4,), "half": (2, 2), "uneven": (1, 3)}


def _run(chain, x, frames):
    n = chain.fft_size
    state, outs, lo = None, [], 0
    for f in frames:
        (sr, si), state = chain(jnp.asarray(x[:, lo:lo + f * n]), state)
        outs.append(np.asarray(sr, np.float64)
                    + 1j * np.asarray(si, np.float64))
        lo += f * n
    return np.concatenate(outs, axis=1), state


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("fft_size", [1024, 2048, 4096, 8192, 16384])
def test_f64_matches_oracle(rng, fft_size, split):
    chain = NorthStarChain(fft_size=fft_size, dtype=jnp.float64)
    x = rng.standard_normal((2, 4 * fft_size))
    got, state = _run(chain, x, SPLITS[split])
    ref = chain_spectra(chain.design, x, fft_size)
    assert got.shape == ref.shape == (2, 4, fft_size // 2)
    assert snr_db(got, ref) > 250.0
    assert state.y_hist.shape == (2, chain.design.nsections + 1, 2)


@pytest.mark.parametrize("fft_size", [1024, 2048, 4096])
def test_f32_highest_meets_the_130db_bar(rng, fft_size):
    chain = NorthStarChain(fft_size=fft_size, dtype=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
    x = rng.standard_normal((2, 4 * fft_size)).astype(np.float32)
    got, _ = _run(chain, x, SPLITS["half"])
    assert snr_db(got, chain_spectra(chain.design, x, fft_size)) >= 130.0
