"""Bucket-aligned spatial hash table as pure-functional JAX ops.

Functional replacement for the reference's GPU hash
(`/root/reference/utils/tsdf/voxel_hash.cu`: 2^21 buckets x 2 entries,
chained-list overflow, per-bucket spin locks with drop-on-contention).
Chained lists are pointer chasing and spin locks need atomics — neither
maps to XLA. Instead:

  - the table is 2^(log2_size-4) aligned buckets of BUCKET=16 slots.
    Aligned buckets make every probe a ROW gather of a [B, 16] array:
    one contiguous 64-byte read per probe instead of 16 element
    gathers. Lookups
    compare the whole bucket vectorized, so there is no early-exit
    divergence and deletion needs no tombstones.
  - insertion is a deterministic CONFLICT-FREE rank protocol (no
    atomics, no claim/retry): sort the batch by bucket id (stable,
    carrying batch position), give each key its rank r among same-bucket
    keys, and assign it the (r+1)-th empty slot of its bucket. Distinct
    keys can never collide (distinct ranks -> distinct empty slots;
    distinct buckets are disjoint rows), and a key fails only if its
    bucket is genuinely full. Failures are reported and counted (the
    reference *silently drops* contended allocations and retries next
    frame, `voxel_hash.cu:71-77` — we keep that best-effort retry
    semantic but surface the count).

All functions are jit-compatible with static shapes and are safe to vmap
or shard: the table is just two int32 arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ra_slam_tpu.map.blocks import INVALID_KEY, hash_key

BUCKET_LOG2 = 4
BUCKET = 1 << BUCKET_LOG2  # 16 slots per bucket

# Kept for callers that size probe windows; one bucket is the window.
MAX_PROBE = BUCKET


class HashTable(NamedTuple):
    """key[T] (INVALID_KEY = empty) and value[T] (pool block index),
    T = 2^log2_size slots = 2^(log2_size-4) buckets of 16."""

    key: jax.Array
    value: jax.Array

    @property
    def log2_size(self) -> int:
        return (self.key.shape[0]).bit_length() - 1

    @property
    def num_buckets(self) -> int:
        return self.key.shape[0] >> BUCKET_LOG2

    @staticmethod
    def create(log2_size: int) -> "HashTable":
        if log2_size < BUCKET_LOG2:
            raise ValueError(f"log2_size must be >= {BUCKET_LOG2}")
        size = 1 << log2_size
        return HashTable(
            key=jnp.full((size,), INVALID_KEY, dtype=jnp.int32),
            value=jnp.full((size,), -1, dtype=jnp.int32),
        )


def _bucket_of(table: HashTable, keys: jax.Array) -> jax.Array:
    return hash_key(keys, table.log2_size - BUCKET_LOG2)


def ht_lookup(table: HashTable, keys: jax.Array) -> jax.Array:
    """Batched lookup: keys [Q] int32 -> block index [Q] (-1 = not found).

    INVALID_KEY queries return -1.
    """
    b = _bucket_of(table, keys)
    row_k = table.key.reshape(-1, BUCKET)[b]  # [Q, 16]
    row_v = table.value.reshape(-1, BUCKET)[b]
    match = (row_k == keys[:, None]) & (keys != INVALID_KEY)[:, None]
    return jnp.max(jnp.where(match, row_v, -1), axis=-1)


def ht_insert(
    table: HashTable,
    keys: jax.Array,
    values: jax.Array,
    valid: jax.Array,
) -> Tuple[HashTable, jax.Array, jax.Array]:
    """Batched insert of (key, value) pairs.

    Args:
      keys:   [K] int32 — must be unique among valid entries and not
              already present in the table (dedup + lookup first).
      values: [K] int32 — pool indices to store.
      valid:  [K] bool — entries to actually insert.

    Returns (new_table, slots [K] int32 (-1 if failed), placed [K] bool).
    """
    K = keys.shape[0]
    B = table.num_buckets
    size = table.key.shape[0]
    ids = jnp.arange(K, dtype=jnp.int32)

    # Sort by bucket (invalid entries to a sentinel bucket B at the
    # end), carrying the original batch position.
    b = jnp.where(valid, _bucket_of(table, keys), B)
    sb, sid = jax.lax.sort((b, ids), num_keys=1, is_stable=True)

    # Within-bucket rank: position among same-bucket keys.
    pos = jnp.arange(K, dtype=jnp.int32)
    seg_start = jnp.concatenate(
        [jnp.ones((1,), bool), sb[1:] != sb[:-1]]
    )
    start_idx = jax.lax.cummax(jnp.where(seg_start, pos, 0))
    rank = pos - start_idx  # [K]

    # Each key takes the (rank+1)-th empty slot of its bucket.
    row_k = table.key.reshape(-1, BUCKET)[jnp.minimum(sb, B - 1)]  # [K, 16]
    empty = row_k == INVALID_KEY
    n_empty_sofar = jnp.cumsum(empty.astype(jnp.int32), axis=-1)
    hit = empty & (n_empty_sofar == (rank + 1)[:, None])
    placed_s = jnp.any(hit, axis=-1) & (sb < B)
    slot_s = jnp.where(
        placed_s,
        (sb << BUCKET_LOG2) + jnp.argmax(hit, axis=-1).astype(jnp.int32),
        -1,
    )

    # Conflict-free writes (distinct slots by construction).
    widx = jnp.where(placed_s, slot_s, size)
    skeys = keys[sid]
    svals = values[sid]
    new_table = HashTable(
        table.key.at[widx].set(skeys, mode="drop"),
        table.value.at[widx].set(svals, mode="drop"),
    )

    # Un-sort results back to batch order.
    slots = jnp.full((K,), -1, dtype=jnp.int32).at[sid].set(slot_s)
    placed = jnp.zeros((K,), bool).at[sid].set(placed_s)
    return new_table, slots, placed


def ht_remove(table: HashTable, slots: jax.Array, mask: jax.Array) -> HashTable:
    """Clear table entries at `slots` [K] where mask [K] is set.

    O(1) deletion: lookups scan the full bucket, so no tombstones are
    needed.
    """
    size = table.key.shape[0]
    idx = jnp.where(mask, slots, size)
    return HashTable(
        table.key.at[idx].set(INVALID_KEY, mode="drop"),
        table.value.at[idx].set(-1, mode="drop"),
    )
