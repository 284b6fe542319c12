"""Descriptor matching as a Hamming-distance matmul.

Replacement for ``cv2.FlannBasedMatcher(...).knnMatch(k=2)`` plus the Lowe
ratio test (``processor.py:132-137``). The reference uses an *approximate*
LSH matcher; here the full exact distance matrix is one matmul — for binary descriptors a, b with bits in {0, 1}:

    hamming(a, b) = popcount(a XOR b) = |a| + |b| - 2 a.b

so the (Q, T) distance matrix is ``|a|_row + |b|_col - 2 A @ B^T`` — exactly
a large bf16 matmul with f32 accumulation, tensor-core work. Exact beats approximate
here (SURVEY.md §2.4). Top-2 selection is two masked row minima (cheaper
than a sort), then Lowe's ratio + optional cross-check, all static-shaped.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["Matches", "hamming_matrix", "match_descriptors"]


class Matches(NamedTuple):
    query_idx: jax.Array  # (M,) int32 index into the query set
    train_idx: jax.Array  # (M,) int32 index into the train set
    distance: jax.Array  # (M,) float32 best Hamming distance
    mask: jax.Array  # (M,) bool validity


def hamming_matrix(query: jax.Array, train: jax.Array) -> jax.Array:
    """(Q, T) Hamming distances between bit descriptors (int8 {0,1} rows)."""
    q = query.astype(jnp.float32)
    t = train.astype(jnp.float32)
    # bfloat16 inputs run on the tensor cores; 256-long dot products of
    # {0,1} values are exactly representable (sums <= 256 < 2^8 precision
    # of the f32 accumulator).
    dot = jax.lax.dot_general(
        q.astype(jnp.bfloat16),
        t.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    nq = jnp.sum(q, axis=1, keepdims=True)
    nt = jnp.sum(t, axis=1, keepdims=True)
    return nq + nt.T - 2.0 * dot


@partial(jax.jit, static_argnames=("max_matches", "cross_check"))
def match_descriptors(
    query: jax.Array,
    train: jax.Array,
    query_mask: jax.Array,
    train_mask: jax.Array,
    ratio: float = 0.75,
    max_distance: float = 256.0,
    max_matches: int = 4096,
    cross_check: bool = True,
) -> Matches:
    """knnMatch(k=2) + Lowe ratio + cross-check, one XLA program.

    Args:
      query: (Q, 256) int8 bit descriptors (the previous keyframe's,
        ``prev_orb_descriptors`` in ``processor.py:133``).
      train: (T, 256) int8 bit descriptors (the new keyframe's).
      query_mask / train_mask: validity of the padded descriptor slots.
      ratio: Lowe threshold (reference: 0.75, ``processor.py:113``).
      max_distance: reject matches with best distance above this.
      max_matches: static output capacity; strongest matches kept.
      cross_check: also require mutual nearest neighbours (the robust
        index-based association the SoA track store relies on).

    Returns:
      Matches (query_idx, train_idx, distance, mask), best-distance-first.
    """
    big = jnp.float32(1e9)
    d = hamming_matrix(query, train)
    d = jnp.where(train_mask[None, :], d, big)
    d = jnp.where(query_mask[:, None], d, big)

    # Row-wise top-2 via two masked minima. The best entry is masked with an
    # iota compare rather than a scatter: a broadcast select of the same
    # shape fuses with the surrounding elementwise work.
    best_t = jnp.argmin(d, axis=1)  # (Q,)
    best_d = jnp.take_along_axis(d, best_t[:, None], axis=1)[:, 0]
    iota_t = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    second_d = jnp.min(jnp.where(iota_t == best_t[:, None], big, d), axis=1)

    good = best_d < ratio * second_d  # Lowe ratio (processor.py:136-137)
    good &= best_d <= max_distance
    good &= query_mask

    if cross_check:
        # Mutual nearest: the train column's best query must be this row.
        best_q_for_t = jnp.argmin(d, axis=0)  # (T,)
        good &= best_q_for_t[best_t] == jnp.arange(d.shape[0])

    # Keep the strongest max_matches by ascending distance.
    scores = jnp.where(good, -best_d, -big)
    k = min(max_matches, scores.shape[0])
    top_scores, qidx = jax.lax.top_k(scores, k)
    keep = top_scores > -big
    return Matches(
        query_idx=qidx.astype(jnp.int32),
        train_idx=best_t[qidx].astype(jnp.int32),
        distance=jnp.where(keep, -top_scores, jnp.inf),
        mask=keep,
    )
