"""Masked index compaction: variable-size outputs on fixed-shape hardware.

The reference's collect path just pushes hits into a Vec
(query/src/collect_points.rs:29-31). On a device, match counts are unpredictable
(the paper's queries range 35 M ... 2.6 B hits) while shapes must be static,
so collection is two-pass (SURVEY §7 "hard parts"):

  pass 1: count hits per block (cheap fused scan, predicate.py)
  pass 2: for blocks with hits, extract hit indices into a power-of-two
          bucket-capped buffer -> at most log2(block_size) distinct compiled
          shapes, reused forever after warm-up.

`jnp.nonzero(..., size=cap)` lowers to a cumsum + scatter.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def pow2_bucket(count: int, block_size: int) -> int:
    """Smallest power-of-two capacity >= count (<= block_size)."""
    if count <= 0:
        return 0
    cap = 1
    while cap < count:
        cap <<= 1
    return min(cap, block_size)


@functools.partial(jax.jit, static_argnames=("cap",))
def compact_indices(mask, *, cap: int):
    """Indices of True entries, padded to `cap` with fill value len(mask).

    Returns (indices[cap] int32, count int32). Indices come out sorted
    ascending, preserving file order like the reference's sequential push.
    """
    n = mask.shape[0]
    (idx,) = jnp.nonzero(mask, size=cap, fill_value=n)
    return idx.astype(jnp.int32), jnp.sum(mask, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("cap",))
def compact_gather(mask, values, *, cap: int):
    """Gather rows of `values` where mask is set (padded to cap)."""
    n = mask.shape[0]
    (idx,) = jnp.nonzero(mask, size=cap, fill_value=n)
    safe = jnp.minimum(idx, n - 1)
    taken = jnp.take(values, safe, axis=0)
    return taken, idx.astype(jnp.int32), jnp.sum(mask, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("cap",))
def bbox_compact(x, y, z, lo, hi, n_valid, *, cap: int):
    """Fused bbox predicate + index compaction: one XLA pass from raw int32
    coords to hit indices — the mask never materializes in HBM on its own."""
    from .predicate import bbox_mask_jnp

    mask = bbox_mask_jnp(x, y, z, lo, hi, n_valid)
    (idx,) = jnp.nonzero(mask, size=cap, fill_value=x.shape[0])
    return idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cap",))
def class_compact(cls, class_value, n_valid, *, cap: int):
    from .predicate import class_mask_jnp

    mask = class_mask_jnp(cls, class_value, n_valid)
    (idx,) = jnp.nonzero(mask, size=cap, fill_value=cls.shape[0])
    return idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cap",))
def time_compact(th, tl, q, n_valid, *, cap: int):
    """Fused encoded-GPS-time predicate + index compaction."""
    from .predicate import time_mask_jnp

    mask = time_mask_jnp(th, tl, q, n_valid)
    (idx,) = jnp.nonzero(mask, size=cap, fill_value=th.shape[0])
    return idx.astype(jnp.int32)


def masked_collect_multi(mask, *, cap: int):
    """(K, B) mask -> per-block (counts (K,), hit indices (K, cap)).

    counts is the TRUE per-block hit count (independent of cap); indices
    beyond cap are dropped — the caller detects counts > cap and retries
    that block with a bigger bucket. Used inside the sharded collect step
    so a whole D*K-block batch compacts in one dispatch.
    """
    n = mask.shape[1]
    counts = jnp.sum(mask, axis=1, dtype=jnp.int32)
    idx = jax.vmap(
        lambda m: jnp.nonzero(m, size=cap, fill_value=n)[0].astype(jnp.int32)
    )(mask)
    return counts, idx
