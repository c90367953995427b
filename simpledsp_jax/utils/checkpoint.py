"""Checkpoint / resume for streaming pipeline state.

The reference's resumable state is the filter memory itself (reference:
include/sdsp/casc_2o_iir.h:78-79; proven resumable at test/testIIR.cpp:61-75).
Here every op's carried state is an explicit pytree of arrays, so
checkpointing is generic: flatten the pytree, save the leaves as an .npz
plus the treedef, restore on any host/device layout.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any

import jax
import numpy as np

from simpledsp_jax.utils.host import to_numpy

__all__ = ["save_state", "load_state"]


def save_state(path, state: Any) -> None:
    """Save any state pytree (IIRState, FIRState, SDRState, tuples...) to
    ``path`` (.npz).  Complex leaves are split into float planes for
    transfer safety (see utils/host.py), then recombined on load."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {}
    meta = []
    for i, leaf in enumerate(leaves):
        a = to_numpy(leaf)
        if np.iscomplexobj(a):
            arrays[f"leaf{i}_re"] = a.real
            arrays[f"leaf{i}_im"] = a.imag
            meta.append("complex")
        else:
            arrays[f"leaf{i}"] = np.asarray(a)
            meta.append("real")
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"n": len(leaves), "kinds": meta,
                    "treedef": str(treedef)}).encode(), dtype=np.uint8)
    np.savez(pathlib.Path(path), **arrays)


def load_state(path, like: Any) -> Any:
    """Load a state pytree saved by :func:`save_state`.

    ``like`` supplies the pytree structure (e.g. a freshly initialized
    state of the same pipeline); leaf values are replaced by the saved
    arrays (cast to the prototype leaf dtypes).
    """
    data = np.load(pathlib.Path(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    if meta["n"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {meta['n']} leaves, prototype has "
            f"{len(leaves_like)}")
    out = []
    for i, (kind, proto) in enumerate(zip(meta["kinds"], leaves_like)):
        if kind == "complex":
            a = data[f"leaf{i}_re"] + 1j * data[f"leaf{i}_im"]
        else:
            a = data[f"leaf{i}"]
        out.append(np.asarray(a, dtype=np.asarray(proto).dtype
                              if not hasattr(proto, "dtype") else proto.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)
