"""Scatter-based stream compaction primitives.

jnp.nonzero(size=...) lowers to a searchsorted (log N rounds of large
gathers), which is slow for big arrays. These replacements are
single-pass: an exclusive-rank cumsum plus one scatter.
"""

from __future__ import annotations

import jax.numpy as jnp


def masked_indices(mask, cap: int, fill: int):
    """Indices of the first `cap` True entries of a flat bool mask,
    padded with `fill` (ascending order, deterministic).

    Equivalent to jnp.nonzero(mask, size=cap, fill_value=fill)[0] but one
    cumsum + one scatter instead of a bisection."""
    n = mask.shape[0]
    m32 = mask.astype(jnp.int32)
    rank = jnp.cumsum(m32) - m32  # exclusive rank among True entries
    slot = jnp.where(mask & (rank < cap), rank, cap)
    idx = (
        jnp.full((cap + 1,), fill, jnp.int32)
        .at[slot]
        .set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    )
    return idx[:cap]


def staircase_last_le(w0, W: int, K: int):
    """For each word w in [0, W): index of the last symbol k (within its
    chunk's row) with w0[k] <= w.

    w0: (C, K) per-chunk nondecreasing 0/1-increment staircases where every
    word has at least one symbol. Single scatter-max of the symbol index at
    its word position (replaces a log2(K)-round take_along_axis bisection)."""
    C = w0.shape[0]
    k_ids = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (C, K))
    tgt = jnp.clip(w0, 0, W - 1)
    e = (
        jnp.zeros((C, W), jnp.int32)
        .at[jnp.arange(C, dtype=jnp.int32)[:, None], tgt]
        .max(k_ids)
    )
    # a chunk's final word can be a pure spill word (no symbol *starts* in
    # it): propagate the running maximum so it inherits the last symbol of
    # the preceding word
    from jax import lax

    return lax.cummax(e, axis=1)
