"""Numerical-safety checks (SURVEY.md §5 "race detection / sanitizers" plan).

The reference's analog is compiler warnings + clang-analyzer (it is
single-threaded, so static analysis stands in for sanitizers).  Here the
failure modes are numerical: NaN/Inf escaping a chain (unstable filter
design, overflow in f32).  ``checked`` wraps any jittable step function
with jax.experimental.checkify NaN/div checks; ``assert_stable`` validates
a biquad design's poles up front (the cheap static gate).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np

import jax
from jax.experimental import checkify

from simpledsp_jax.design.biquad import BiquadCascadeDesign

__all__ = ["checked", "assert_stable", "pole_radii"]


def checked(fn: Callable, *, jit: bool = True) -> Callable:
    """Wrap a step function with float checks (NaN/Inf/div) — returns a
    callable that raises `checkify.JaxRuntimeError` with a located message
    instead of silently propagating NaNs."""
    cf = checkify.checkify(fn, errors=checkify.float_checks)
    if jit:
        cf = jax.jit(cf)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = cf(*args, **kwargs)
        err.throw()
        return out

    return wrapper


def pole_radii(design: BiquadCascadeDesign) -> np.ndarray:
    """|pole| per section — all must be < 1 for stability."""
    radii = []
    for k in range(design.nsections):
        a = design.a[k]
        roots = np.roots(a)
        radii.append(np.abs(roots).max())
    return np.asarray(radii)


def assert_stable(design: BiquadCascadeDesign, margin: float = 1e-9) -> None:
    """Raise if any section pole is on/outside the unit circle."""
    r = pole_radii(design)
    if (r >= 1.0 - margin).any():
        raise ValueError(
            f"unstable design: section pole radii {r} (limit < 1); "
            f"check f0/fs/Q parameters")
