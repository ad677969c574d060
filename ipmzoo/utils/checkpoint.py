"""Solver-state checkpoint / resume.

The reference has no serialization at all (SURVEY §5); for long batched
runs on preemptible accelerator pools the solver state (a small pytree) is worth
persisting.  Plain ``.npz`` keeps zero extra dependencies; orbax can be
layered on by passing its checkpointer the same pytree.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_state(path: str, state, metadata: dict | None = None) -> None:
    """Save an IPMState/SchurState (or any pytree of arrays) to .npz.

    Only the leaves are stored; reconstruction requires a structurally
    identical ``like`` tree at load time (see :func:`load_state`) — the
    treedef itself has no stable, pickle-free serialization."""
    import jax
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    arrays["__num_leaves__"] = np.asarray(len(leaves))
    if metadata:
        arrays["__metadata__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_state(path: str, like):
    """Load a state saved by :func:`save_state`; ``like`` provides the
    pytree structure (e.g. a freshly built state)."""
    import jax
    import jax.numpy as jnp
    with np.load(path, allow_pickle=False) as data:
        leaves_like, treedef = jax.tree_util.tree_flatten(like)
        if "__num_leaves__" in data and \
                int(data["__num_leaves__"]) != len(leaves_like):
            raise ValueError(
                f"checkpoint has {int(data['__num_leaves__'])} leaves but "
                f"'like' tree has {len(leaves_like)}: structure mismatch")
        leaves = [jnp.asarray(data[f"leaf_{i}"])
                  for i in range(len(leaves_like))]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def load_metadata(path: str) -> dict | None:
    with np.load(path, allow_pickle=False) as data:
        if "__metadata__" not in data:
            return None
        return json.loads(bytes(data["__metadata__"]).decode())
