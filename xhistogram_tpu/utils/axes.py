"""Axis bookkeeping: static-shape canonicalization to a 2-D layout.

The whole compute path operates on a canonical 2-D view
``(kept_rows, reduce_cols)``: reduced axes are moved to the end and flattened,
kept (bystander) axes are flattened in front. This is the same canonical
layout as the reference's ``reshape_input`` (reference core.py:211-229), but
implemented as pure static-shape jnp transforms so it traces cleanly under
jit — axis sets are static arguments, and each distinct axis combination
compiles once.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

__all__ = ["normalize_axis", "canonicalize_2d", "kept_shape"]


def normalize_axis(axis, ndim):
    """Normalize ``axis`` to a sorted tuple of unique non-negative ints.

    ``None`` (reduce everything) stays ``None``. Mirrors the reference's
    normalization loop (core.py:341-352) including the bounds check.
    """
    if axis is None:
        return None
    if isinstance(axis, (int,)):
        axis = (axis,)
    out = []
    for ax in axis:
        ax = int(ax)
        ax_pos = ax if ax >= 0 else ndim + ax
        if not (0 <= ax_pos < ndim):
            raise ValueError(
                f"axis {ax} is out of bounds for array of dimension {ndim}"
            )
        out.append(ax_pos)
    if len(set(out)) != len(out):
        raise ValueError(f"repeated axis in {axis}")
    return tuple(sorted(out))


def kept_shape(shape, axis):
    """Shape of the preserved (bystander) axes, in original order."""
    if axis is None:
        return ()
    return tuple(s for i, s in enumerate(shape) if i not in axis)


def canonicalize_2d(a, axis):
    """Reshape ``a`` to ``(n_kept_rows, n_reduce_cols)``.

    ``axis=None`` reduces everything → ``(1, a.size)``. Otherwise the reduced
    axes are moved (in the given order) to the trailing positions and both
    groups are flattened. Static-shape equivalent of reference
    core.py:211-229.
    """
    if axis is None or set(axis) == set(range(a.ndim)):
        return a.reshape(1, max(a.size, 0))
    new_pos = tuple(range(-len(axis), 0))
    c = jnp.moveaxis(a, axis, new_pos)
    split = c.ndim - len(axis)
    m = math.prod(c.shape[:split])
    n = math.prod(c.shape[split:])
    return c.reshape(m, n)
