"""Host-transfer helpers.

``to_numpy`` fetches an array or pytree to host numpy; complex arrays are
split into (real, imag) float planes on the device, transferred as floats
(the framework's RI carrier), and recombined on the host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["to_numpy"]


def _fetch(x) -> np.ndarray:
    if jnp.iscomplexobj(x):
        re = np.asarray(jnp.real(x))
        im = np.asarray(jnp.imag(x))
        return re + 1j * im
    return np.asarray(x)


def to_numpy(tree):
    """Fetch an array or pytree of arrays to host numpy, routing complex
    arrays through per-plane float transfers."""
    return jax.tree_util.tree_map(_fetch, tree)
