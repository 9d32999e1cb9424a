"""Binary descriptor matching.

The reference outsources matching to OpenVSLAM (reprojection search +
Hamming tests) and loop retrieval to DBoW2 (SURVEY.md §2.8). Here the
formulation is *dense*: the full Hamming distance matrix between two
descriptor sets. Unpacking 256-bit descriptors to ±1 vectors turns
Hamming distance into a matmul:

    hamming(a, b) = (256 - <±1(a), ±1(b)>) / 2

which runs on the tensor cores in bf16 (exact for ±1 operands), and it
replaces both brute-force matching *and* the bag-of-words shortlist
(loop-closure retrieval = top-k over the same matrix against the
keyframe database). On an H100 (400 W limit) at 1000 x 20000 it takes
122 us, against 209 us for XOR + popcount and 131 us for a Pallas
XOR + popcount kernel.

`hamming_matrix_popcount` (XOR + population_count) is kept as the exact
integer reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ra_slam_tpu.features.orb import DESC_WORDS, NUM_PAIRS


def unpack_pm1(desc: jax.Array) -> jax.Array:
    """[K, 8] uint32 -> [K, 256] float32 in {-1, +1} (invalid-safe)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None]) & jnp.uint32(1)
    return (bits.reshape(desc.shape[0], NUM_PAIRS).astype(jnp.float32) * 2.0) - 1.0


def hamming_matrix(desc_a: jax.Array, desc_b: jax.Array) -> jax.Array:
    """Full Hamming distance matrix [Ka, Kb] float32: the ±1 matmul in
    bf16 with float32 accumulation. Exact: ±1 is exact in bf16 and
    every partial sum is an integer of magnitude <= 256."""
    a = unpack_pm1(desc_a).astype(jnp.bfloat16)
    b = unpack_pm1(desc_b).astype(jnp.bfloat16)
    dot = jnp.matmul(a, b.T, preferred_element_type=jnp.float32)
    return (NUM_PAIRS - dot) * 0.5


def hamming_matrix_popcount(desc_a: jax.Array, desc_b: jax.Array) -> jax.Array:
    """Exact integer Hamming matrix via XOR + popcount (O(Ka*Kb*8))."""
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


class Matches(NamedTuple):
    """Fixed-size match set: for every query keypoint, its best target."""

    idx: jax.Array  # [Ka] int32 best match in b (always set)
    dist: jax.Array  # [Ka] float32 best Hamming distance
    valid: jax.Array  # [Ka] bool passed ratio/threshold/mutual tests


def match_descriptors(
    desc_a: jax.Array,
    valid_a: jax.Array,
    desc_b: jax.Array,
    valid_b: jax.Array,
    max_distance: float = 64.0,
    ratio: float = 0.8,
) -> Matches:
    """Best-match with Lowe ratio test (best < ratio * second-best)."""
    d = hamming_matrix(desc_a, desc_b)
    d = jnp.where(valid_b[None, :], d, jnp.inf)
    neg = -d
    top2, idx2 = jax.lax.top_k(neg, 2)
    best = -top2[:, 0]
    second = -top2[:, 1]
    ok = (
        valid_a
        & (best <= max_distance)
        & (best < ratio * jnp.minimum(second, NUM_PAIRS))
    )
    return Matches(idx=idx2[:, 0].astype(jnp.int32), dist=best, valid=ok)


def mutual_match(
    desc_a: jax.Array,
    valid_a: jax.Array,
    desc_b: jax.Array,
    valid_b: jax.Array,
    max_distance: float = 64.0,
    ratio: float = 0.8,
) -> Matches:
    """Cross-check matching: a->b and b->a must agree."""
    m_ab = match_descriptors(desc_a, valid_a, desc_b, valid_b, max_distance, ratio)
    m_ba = match_descriptors(desc_b, valid_b, desc_a, valid_a, max_distance, ratio)
    back = m_ba.idx[m_ab.idx]
    agree = back == jnp.arange(desc_a.shape[0], dtype=jnp.int32)
    return Matches(idx=m_ab.idx, dist=m_ab.dist, valid=m_ab.valid & agree)
