"""Solver-state checkpoint/resume.

The reference has no unified checkpoint system (SURVEY.md §5 — only
MatrixMarket writers and EpetraExt HDF5 containers). Long device solves
want one: save any solve-state pytree (x, r, Krylov basis, H, recycle
space, AMG level arrays) and resume. Plain ``.npz`` with a JSON manifest
of the tree structure — no orbax dependency, restartable anywhere.
"""
from __future__ import annotations

import json
import os

import numpy as np

import jax
import jax.numpy as jnp


def save_state(path: str, tree) -> None:
    """Save a pytree of arrays (+ scalars) to ``path`` (.npz)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(str(treedef)).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_state(path: str, like):
    """Load arrays saved by save_state into the structure of ``like``
    (a pytree with matching leaf count/order)."""
    data = np.load(path)
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    n = len(leaves_like)
    loaded = [jnp.asarray(data[f"leaf_{i}"]) for i in range(n)]
    return jax.tree_util.tree_unflatten(treedef, loaded)


def checkpointed_solve(solver, op, b, *, path: str, every_cycles: int = 1,
                       cycle_iters: int = 50, rtol: float = 1e-8,
                       maxiter: int = 10000, **kw):
    """Run a solver in resumable chunks: each chunk is a ``maxiter=cycle_
    iters`` call continuing from the stored x; state lands in ``path``
    after every ``every_cycles`` chunks. Resumes automatically when the
    checkpoint exists."""
    import jax.numpy as jnp

    x0 = kw.pop("x0", None)
    if os.path.exists(path):
        x0 = load_state(path, jnp.zeros_like(b))
    total = 0
    res = None
    while total < maxiter:
        res = solver(op, b, x0=x0, rtol=rtol, maxiter=cycle_iters, **kw)
        total += int(res.iters)
        x0 = res.x
        save_state(path, res.x)
        if bool(jnp.all(res.converged)) or int(res.iters) == 0:
            break
    return res
