"""Dual-backend primitive shim: NumPy (host reference) / JAX (device path).

The reference validates every GPU backend against its SERIAL adapter
(reference: tests/mgard-x/CMakeLists.txt:12-53 — the serial implementation is
the oracle). We mirror that: the whole transform is written once against this
tiny op set; with NumPy inputs it runs eagerly on host (fast, no XLA
compilation — the correctness oracle), with JAX inputs it traces into the
fused device program.
"""

from __future__ import annotations

import numpy as np


def is_np(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic))


def sl(v, axis: int, start: int, stop: int, stride: int = 1):
    if is_np(v):
        idx = [slice(None)] * v.ndim
        idx[axis] = slice(start, stop, stride)
        return v[tuple(idx)]
    from jax import lax

    return lax.slice_in_dim(v, start, stop, stride=stride, axis=axis)


def pad_zero(v, axis: int, before: int, after: int):
    if before == 0 and after == 0:
        return v
    if is_np(v):
        cfg = [(0, 0)] * v.ndim
        cfg[axis] = (before, after)
        return np.pad(v, cfg)
    import jax.numpy as jnp
    from jax import lax

    cfg = [(0, 0, 0)] * v.ndim
    cfg[axis] = (before, after, 0)
    return lax.pad(v, jnp.zeros((), v.dtype), cfg)


def concat(parts, axis: int):
    if is_np(parts[0]):
        return np.concatenate(parts, axis=axis)
    import jax.numpy as jnp

    return jnp.concatenate(parts, axis=axis)


def stack2_reshape(a, b, axis: int):
    """Interleave two equal-shaped arrays along `axis`:
    returns shape with axis doubled, entries a0,b0,a1,b1,..."""
    if is_np(a):
        stacked = np.stack([a, b], axis=axis + 1)
    else:
        import jax.numpy as jnp

        stacked = jnp.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] = 2 * a.shape[axis]
    return stacked.reshape(shape)


def update_box(v, box, ndim: int):
    """Write `box` into the leading corner of `v`."""
    if is_np(v):
        out = v.copy()
        out[tuple(slice(0, s) for s in box.shape)] = box
        return out
    from jax import lax

    return lax.dynamic_update_slice(v, box, (0,) * ndim)


def zeros(shape, dtype, like):
    if is_np(like):
        return np.zeros(shape, dtype)
    import jax.numpy as jnp

    return jnp.zeros(shape, dtype)


def asarray_like(table, like, shape=None):
    """Bring a host table into the computation; reshape for broadcasting."""
    if is_np(like):
        arr = np.asarray(table)
    else:
        import jax.numpy as jnp

        arr = jnp.asarray(table)
    if shape is not None:
        arr = arr.reshape(shape)
    return arr


def linrec(d, f, axis: int, reverse: bool):
    """First-order linear recurrence along `axis`:
    y_i = d_i + f_i * y_{i-1} (or i+1 when reversed).

    NumPy: sequential sweep (host oracle). JAX: O(log n)-depth associative
    scan — the device evaluation (elements (f,d) compose as
    (fa,da)∘(fb,db) = (fa*fb, db + fb*da)).
    """
    if is_np(d):
        n = d.shape[axis]
        y = np.array(d)  # copy
        ysw = np.moveaxis(y, axis, 0)
        fsw = np.moveaxis(np.broadcast_to(f, d.shape), axis, 0)
        rng = range(n - 2, -1, -1) if reverse else range(1, n)
        step = 1 if reverse else -1
        for i in rng:
            ysw[i] = ysw[i] + fsw[i] * ysw[i + step]
        return y
    import jax.numpy as jnp
    from jax import lax

    def combine(a, b):
        fa, da = a
        fb, db = b
        return fa * fb, db + fb * da

    f_full = jnp.broadcast_to(f, d.shape)
    _, y = lax.associative_scan(combine, (f_full, d), axis=axis, reverse=reverse)
    return y
