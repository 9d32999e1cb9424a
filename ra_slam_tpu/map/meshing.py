"""Isosurface mesh extraction from the TSDF map.

Capability parity with the reference's marching-cubes pipeline
(`/root/reference/utils/tsdf/voxel_tsdf.cu:561-845`: per-block kernel
with 2x2x2 block-neighborhood shared memory, 256-case LUT, vertex
ownership + two prefix-sum compactions), with a batched redesign:

  - **Marching tetrahedra** instead of the 256-case marching-cubes LUT:
    each cube splits into 6 tetrahedra around its main diagonal; each
    tet triangulates from a tiny 16-case table derived from first
    principles in this file. Same isosurface, simpler, fully
    branch-free/vectorizable, and hole-free by construction (tets have
    no ambiguous cases).
  - Block neighborhoods (a [9,9,9] halo grid per block — the exact
    analog of the reference's shared-mem load, voxel_tsdf.cu:583-586)
    are gathered with 7 batched hash lookups per block.
  - **The mesh never exists as float geometry until the very end.**
    Each emitted vertex is identified by its voxel-lattice edge plus an
    interpolation parameter, packed into THREE u32 words (hi, lo key
    pair + u16 u | u16 prob). Emission writes only those 9 words per
    triangle; shared-vertex dedup is a device sort over the key words
    (the reference's per-voxel vertex-ownership + prefix-sum scheme,
    done as one sort-unique); float positions are decoded from the
    packed words AFTER compaction, for unique vertices only.
  - The round-3 implementation moved ~20x this data: it carried 9 f32
    coordinates + 6 key words per triangle through every stage and
    shipped the raw soup to the host for big meshes — 136 s at bench
    scale on the ~20 MB/s host link. This pipeline stays on device
    through dedup and ships only the compacted mesh (and quantizes the
    big-mesh transfer, see `extract_mesh`): 7.1M triangles in seconds.

Binary outputs match `TSDFSystem::DownloadAllMesh`
(`/root/reference/modules/tsdf_module.cc:66-86`): float32 xyz vertex
rows, int32 index triples, float32 per-vertex semantic probabilities.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ra_slam_tpu.core.config import TsdfConfig
from ra_slam_tpu.map.blocks import (
    BLOCK_LEN,
    pack_block_coords,
    unpack_block_coords,
)
from ra_slam_tpu.map.hash_table import ht_lookup
from ra_slam_tpu.map.voxel_map import VoxelMap

# Cube corners: bit0 -> +x, bit1 -> +y, bit2 -> +z.
_CORNER_OFFS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], dtype=np.float32
)

# Six tetrahedra sharing the 0-7 main diagonal.
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]],
    dtype=np.int32,
)

# Tet edges as (corner, corner) index pairs into the tet's 4 corners.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)

# 16-case table: for each inside-bitmask (bit i = tet corner i has
# tsdf < 0), up to two triangles of tet-edge ids (-1 = unused).
# Derived by enumeration: 1 or 3 corners inside -> one triangle of the
# three edges incident to the lone corner; 2 inside -> quad across the
# four separating edges, split into two triangles.
_TET_TRIS = np.array(
    [
        [[-1, -1, -1], [-1, -1, -1]],  # 0000
        [[0, 1, 2], [-1, -1, -1]],     # 0001 a
        [[0, 3, 4], [-1, -1, -1]],     # 0010 b
        [[1, 2, 4], [1, 4, 3]],        # 0011 ab
        [[1, 3, 5], [-1, -1, -1]],     # 0100 c
        [[0, 2, 5], [0, 5, 3]],        # 0101 ac
        [[0, 5, 1], [0, 4, 5]],        # 0110 bc
        [[2, 5, 4], [-1, -1, -1]],     # 0111 abc
        [[2, 4, 5], [-1, -1, -1]],     # 1000 d
        [[0, 1, 5], [0, 5, 4]],        # 1001 ad
        [[0, 5, 2], [0, 3, 5]],        # 1010 bd
        [[1, 5, 3], [-1, -1, -1]],     # 1011 abd
        [[1, 4, 2], [1, 3, 4]],        # 1100 cd
        [[0, 4, 3], [-1, -1, -1]],     # 1101 acd
        [[0, 2, 1], [-1, -1, -1]],     # 1110 bcd
        [[-1, -1, -1], [-1, -1, -1]],  # 1111
    ],
    dtype=np.int32,
)

_NBR_OFFS = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.int32,
)

MAX_TRIS_PER_BLOCK = BLOCK_LEN**3 * 12  # 6 tets x 2 tris per cube

# triangles emitted per tet inside-case (0, 1 or 2) — for the sizing pass
_TET_TRI_COUNT = (_TET_TRIS[:, :, 0] >= 0).sum(axis=1).astype(np.int32)


def _to_xyz(flat_block: jax.Array) -> jax.Array:
    """[512(,C)] voxel payload (idx = x + 8y + 64z) -> [8,8,8(,C)] xyz grid."""
    shp = (BLOCK_LEN, BLOCK_LEN, BLOCK_LEN) + flat_block.shape[1:]
    return jnp.moveaxis(flat_block.reshape(shp), (0, 1, 2), (2, 1, 0))


def _gather_halo(m: VoxelMap, bidx: jax.Array, nbr_idx: jax.Array, field: jax.Array, fill: float):
    """Build the [B, 9, 9, 9] halo grid of `field` ([N,512]) for blocks
    bidx [B] with neighbor pool indices nbr_idx [B, 7] (-1 = missing)."""
    B = bidx.shape[0]
    n = field.shape[0]

    def fetch(idx):  # [B] -> [B,8,8,8], missing -> fill
        safe = jnp.where(idx >= 0, idx, n)
        padded = jnp.concatenate(
            [field, jnp.full((1, field.shape[1]), fill, field.dtype)], axis=0
        )
        return jax.vmap(_to_xyz)(padded[safe])

    own = fetch(bidx)
    nx, ny, nz, nxy, nxz, nyz, nxyz = [fetch(nbr_idx[:, i]) for i in range(7)]

    g = jnp.full((B, 9, 9, 9), fill, dtype=field.dtype)
    g = g.at[:, :8, :8, :8].set(own)
    g = g.at[:, 8, :8, :8].set(nx[:, 0, :, :])
    g = g.at[:, :8, 8, :8].set(ny[:, :, 0, :])
    g = g.at[:, :8, :8, 8].set(nz[:, :, :, 0])
    g = g.at[:, 8, 8, :8].set(nxy[:, 0, 0, :])
    g = g.at[:, 8, :8, 8].set(nxz[:, 0, :, 0])
    g = g.at[:, :8, 8, 8].set(nyz[:, :, 0, 0])
    g = g.at[:, 8, 8, 8].set(nxyz[:, 0, 0, 0])
    return g


def _halo_grids(m: VoxelMap, bidx: jax.Array, fields):
    """Halo grids for several [N,512] fields of blocks bidx [B]
    (one shared 7-neighbor hash lookup). fields: list of (array, fill)."""
    keys = jnp.where(bidx >= 0, m.block_key[jnp.maximum(bidx, 0)], 0)
    coords = unpack_block_coords(keys)
    nbr_keys = pack_block_coords(
        coords[:, None, :] + jnp.asarray(_NBR_OFFS)[None]
    )
    nbr_idx = ht_lookup(m.table, nbr_keys.reshape(-1)).reshape(nbr_keys.shape)
    return coords, [
        _gather_halo(m, bidx, nbr_idx, f, fill) for f, fill in fields
    ]


def _corners(g: jax.Array) -> jax.Array:
    """[9,9,9] halo grid -> [512, 8] cube-corner samples (cube index is
    x-slowest: reshape(-1) of the [x, y, z] grid)."""
    return jnp.stack(
        [
            g[cx : cx + 8, cy : cy + 8, cz : cz + 8]
            for cx, cy, cz in _CORNER_OFFS.astype(np.int32)
        ],
        axis=-1,
    ).reshape(-1, 8)


@partial(jax.jit, static_argnames=("min_weight",))
def _count_chunk(
    m: VoxelMap, bidx: jax.Array, min_weight: float
) -> jax.Array:
    """Exact per-block triangle counts [chunk] for one chunk of blocks —
    the sizing pass (the analog of the reference's count-then-gather
    prefix-sum scheme, `/root/reference/utils/tsdf/voxel_tsdf.cu:736-845`,
    which also runs the kernel once to count before compaction). All LUT
    lookups are select-sums (`_sel_*`) — gathers cost ~8.5 ns/element on
    this chip and dominated the census."""
    _, (t9, w9) = _halo_grids(
        m, bidx, [(m.tsdf, 1.0), (m.weight, 0.0)]
    )
    ct = _corners_b(t9)  # [B, 512, 8]
    cw = _corners_b(w9)
    cube_ok = jnp.all(cw >= min_weight, axis=-1)  # [B, 512]
    tri_count = jnp.asarray(_TET_TRI_COUNT[:, None])  # [16, 1]

    def per_tet(total, tet4):
        t4 = _sel_columns(ct, tet4)
        inside = (t4 < 0).astype(jnp.int32)
        case = (
            inside[..., 0]
            + 2 * inside[..., 1]
            + 4 * inside[..., 2]
            + 8 * inside[..., 3]
        )
        n = _sel_rows(case, tri_count)[..., 0]  # [B, 512]
        return total + jnp.sum(jnp.where(cube_ok, n, 0), axis=1), None

    c, _ = jax.lax.scan(
        per_tet, jnp.zeros(ct.shape[0], jnp.int32), jnp.asarray(_TETS)
    )
    return jnp.where(bidx >= 0, c, 0)


def _surface_census(m: VoxelMap, min_weight: float, chunk: int = 2048):
    """Per-surface-block pool indices + triangle counts.

    Chained-dispatch chunk loop over ACTIVE blocks (dispatches are
    ~0.75 ms; the fat 2048-block chunks keep the loop to a handful of
    programs); returns numpy (surf_idx [S], surf_counts [S]) covering
    exactly the blocks that emit >= 1 triangle, in pool-compaction order
    — the analog of the reference's count-then-gather prefix-sum scheme
    (`/root/reference/utils/tsdf/voxel_tsdf.cu:736-845`)."""
    order, n_active = _active_order(m)
    n_act = int(n_active)
    n_chunks = max(1, (n_act + chunk - 1) // chunk)
    order = jnp.concatenate([order, jnp.full((chunk,), -1, jnp.int32)])
    counts = []
    for c in range(n_chunks):
        bidx = jax.lax.dynamic_slice(order, (c * chunk,), (chunk,))
        counts.append(_count_chunk(m, bidx, min_weight))
    # ONE device->host round-trip for all chunks (per-chunk np.asarray
    # would pay the transfer latency n_chunks times)
    counts = np.asarray(jnp.concatenate(counts))
    order_np = np.asarray(order[: n_chunks * chunk])
    surf = counts > 0
    return order_np[surf], counts[surf]


def _count_device(m: VoxelMap, min_weight: float, chunk: int = 2048) -> int:
    """Total isosurface triangle count as a host int.

    NOTE (round-3 advisor): unlike early rounds this is NOT jittable —
    it drives a host-side chunk loop and returns a Python int; callers
    inside jit must use `_count_chunk` directly."""
    _, surf_counts = _surface_census(m, min_weight, chunk)
    return int(surf_counts.sum())


@jax.jit
def _active_order(m: VoxelMap):
    """Compacted active block indices [N] (-1 padding) + active count."""
    N = m.num_blocks
    act = m.active
    rank = jnp.cumsum(act.astype(jnp.int32)) - 1
    dest = jnp.where(act, rank, N)
    n_active = jnp.sum(act.astype(jnp.int32))
    order = jnp.full((N,), -1, jnp.int32).at[dest].set(
        jnp.arange(N, dtype=jnp.int32), mode="drop"
    )
    return order, n_active


def _sel_columns(vals: jax.Array, ids: jax.Array) -> jax.Array:
    """out[..., k] = vals[..., ids[k]] for a TINY trailing axis, as a
    select-sum instead of a gather (a form chosen where element gathers
    were the cost; whether it beats `take_along_axis` on a GPU is not
    measured).
    vals [..., C], ids [K] (traced) -> [..., K]."""
    C = vals.shape[-1]
    out = jnp.zeros(vals.shape[:-1] + ids.shape, vals.dtype)
    for j in range(C):
        out = jnp.where(ids == j, vals[..., j : j + 1], out)
    return out


def _sel_rows(case: jax.Array, table: jax.Array) -> jax.Array:
    """out[..., :] = table[case[...], :] for a small static table
    (select-sum form of the LUT row lookup). case [...], table [C, K]
    -> [..., K]."""
    out = jnp.zeros(case.shape + (table.shape[1],), table.dtype)
    for c in range(table.shape[0]):
        out = jnp.where((case == c)[..., None], table[c], out)
    return out


def _corners_b(g: jax.Array) -> jax.Array:
    """[B,9,9,9] halo grids -> [B, 512, 8] cube-corner samples."""
    return jnp.stack(
        [
            g[:, cx : cx + 8, cy : cy + 8, cz : cz + 8]
            for cx, cy, cz in _CORNER_OFFS.astype(np.int32)
        ],
        axis=-1,
    ).reshape(g.shape[0], 512, 8)


# static per-tet tables, stacked for the lax.scan over the 6 tetrahedra
_EA_CORNER = _TETS[np.arange(6)[:, None], _TET_EDGES[:, 0][None, :]]  # [6,6]
_EB_CORNER = _TETS[np.arange(6)[:, None], _TET_EDGES[:, 1][None, :]]
_PA_OFFS = _CORNER_OFFS.astype(np.int32)[_EA_CORNER]  # [6, 6, 3]
_PB_OFFS = _CORNER_OFFS.astype(np.int32)[_EB_CORNER]
_TRIS_FLAT = _TET_TRIS.reshape(16, 6)  # [16, 2 tris x 3 edge ids]


def _cube_xyz() -> jax.Array:
    cube_idx = jnp.arange(512)
    return jnp.stack(
        [cube_idx // 64, (cube_idx // 8) % 8, cube_idx % 8], axis=-1
    ).astype(jnp.int32)  # x slowest (see _corners_b)


def _emit_chunk_packed(t9, p9, w9, base, min_weight):
    """Triangulate a whole chunk of blocks from halo grids into PACKED
    per-vertex words.

    Each isosurface vertex lies on a unique voxel-lattice edge; (hi, lo)
    is the canonical packed edge identity (used for shared-vertex
    compaction, replacing the reference's per-voxel vertex-ownership
    scheme, `/root/reference/utils/tsdf/voxel_tsdf.cu:561-715`) and
    aux = u_q16 << 16 | prob_q16 carries the interpolation parameter
    (measured FROM the canonical base endpoint) and the interpolated
    semantic probability. Float positions decode from these words alone
    (`_decode_vertices`), so no float geometry flows through emission.

    The 6 tetrahedra run under ONE lax.scan (6x smaller HLO than the
    unrolled form — compile time on this backend scales brutally with
    program size) with all LUT lookups in select-sum form (`_sel_*`).

    Returns (valid [B*6144] per-tri, hi/lo/aux [B*6144, 3] u32).
    """
    B = t9.shape[0]
    ct = _corners_b(t9)  # [B, 512, 8]
    cw = _corners_b(w9)
    cp = _corners_b(p9)
    cube_ok = jnp.all(cw >= min_weight, axis=-1)  # [B, 512]
    gx = base[:, None, :] + _cube_xyz()[None]  # [B, 512, 3] cube coords

    consts = (
        jnp.asarray(_TETS),  # [6, 4]
        jnp.asarray(_EA_CORNER),  # [6, 6]
        jnp.asarray(_EB_CORNER),
        jnp.asarray(_PA_OFFS),  # [6, 6, 3]
        jnp.asarray(_PB_OFFS),
    )
    tris_flat = jnp.asarray(_TRIS_FLAT)

    def per_tet(carry, c):
        tet4, ea, eb, pa, pb = c
        t4 = _sel_columns(ct, tet4)  # [B, 512, 4]
        inside = (t4 < 0).astype(jnp.int32)
        case = (
            inside[..., 0]
            + 2 * inside[..., 1]
            + 4 * inside[..., 2]
            + 8 * inside[..., 3]
        )  # [B, 512]
        ta = _sel_columns(ct, ea)  # [B, 512, 6]
        tb = _sel_columns(ct, eb)
        pa_p = _sel_columns(cp, ea)
        pb_p = _sel_columns(cp, eb)
        denom = ta - tb
        u = jnp.clip(
            jnp.where(jnp.abs(denom) > 1e-9, ta / denom, 0.5), 0.0, 1.0
        )
        xprob = pa_p + u * (pb_p - pa_p)  # [B, 512, 6]
        ea_xyz = gx[:, :, None, :] + pa[None, None]  # [B, 512, 6, 3]
        eb_xyz = gx[:, :, None, :] + pb[None, None]
        hi6, lo6, u6 = _pack_edge_words(ea_xyz, eb_xyz, u)
        aux6 = (
            (jnp.clip(u6 * 65535.0 + 0.5, 0, 65535).astype(jnp.uint32) << 16)
            | jnp.clip(xprob * 65535.0 + 0.5, 0, 65535).astype(jnp.uint32)
        )
        tri_edges = _sel_rows(case, tris_flat)  # [B, 512, 6]
        evalid = tri_edges.reshape(B, 512, 2, 3)[..., 0] >= 0  # [B, 512, 2]
        sel = jnp.maximum(tri_edges, 0)
        # per-vertex words: out[..., j] = words[..., tri_edges[..., j]]
        vhi = jnp.zeros_like(sel, dtype=jnp.uint32)
        vlo = jnp.zeros_like(sel, dtype=jnp.uint32)
        vaux = jnp.zeros_like(sel, dtype=jnp.uint32)
        for k in range(6):
            pick = sel == k
            vhi = jnp.where(pick, hi6[..., k : k + 1], vhi)
            vlo = jnp.where(pick, lo6[..., k : k + 1], vlo)
            vaux = jnp.where(pick, aux6[..., k : k + 1], vaux)
        valid = evalid & cube_ok[:, :, None]  # [B, 512, 2]
        return carry, (valid, vhi, vlo, vaux)

    _, (valid, vhi, vlo, vaux) = jax.lax.scan(per_tet, None, consts)
    # [6, B, 512, 2] / [6, B, 512, 6] -> candidate-major [B, 512, 6, ...]
    valid = valid.transpose(1, 2, 0, 3).reshape(-1)  # [B*6144]
    vhi = vhi.transpose(1, 2, 0, 3).reshape(-1, 3)  # [B*6144, 3]
    vlo = vlo.transpose(1, 2, 0, 3).reshape(-1, 3)
    vaux = vaux.transpose(1, 2, 0, 3).reshape(-1, 3)
    return valid, vhi, vlo, vaux


def _pack_edge_words(ea: jax.Array, eb: jax.Array, u: jax.Array):
    """Endpoint lattice coords ea/eb [..., 3] int32 + interpolation u
    (from ea) -> canonical (hi, lo, u') u32/f32 words.

    Both endpoints are corners of one lattice cube, so after choosing
    the lexicographically smaller endpoint as the base the per-axis
    delta is in {-1, 0, 1}: key = [x:19][y:19][z:19][delta:5] over 62
    bits, split into two u32 lanes (no int64 anywhere: x64 stays off).
    u is re-measured from the canonical base so every cube incident to
    the edge emits bit-identical words.
    """
    a = (ea + (1 << 18)).astype(jnp.uint32)  # offset-binary, 19 bits
    b = (eb + (1 << 18)).astype(jnp.uint32)

    def proxy(e):
        return (
            (e[..., 0] << jnp.uint32(13))
            ^ (e[..., 1] << jnp.uint32(3))
            ^ e[..., 2]
        )

    a_first = proxy(a) <= proxy(b)
    base = jnp.where(a_first[..., None], a, b)
    other = jnp.where(a_first[..., None], b, a)
    u_c = jnp.where(a_first, u, 1.0 - u)
    d = other.astype(jnp.int32) - base.astype(jnp.int32) + 1  # {0,1,2}
    d5 = (d[..., 0] * 9 + d[..., 1] * 3 + d[..., 2]).astype(jnp.uint32)  # < 27
    x, y, z = base[..., 0], base[..., 1], base[..., 2]
    hi = (x << jnp.uint32(13)) | (y >> jnp.uint32(6))
    lo = (
        ((y & jnp.uint32(0x3F)) << jnp.uint32(26))
        | (z << jnp.uint32(7))
        | d5
    )
    return hi, lo, u_c


def _decode_vertices(hi: jax.Array, lo: jax.Array, aux: jax.Array, voxel_size: float):
    """Packed (hi, lo, aux) words -> (x, y, z world f32, prob f32).
    Inverse of `_pack_edge_words` + aux quantization."""
    x = (hi >> jnp.uint32(13)).astype(jnp.int32)
    y = (((hi & jnp.uint32(0x1FFF)) << jnp.uint32(6)) | (lo >> jnp.uint32(26))).astype(jnp.int32)
    z = ((lo >> jnp.uint32(7)) & jnp.uint32(0x7FFFF)).astype(jnp.int32)
    d5 = (lo & jnp.uint32(0x7F)).astype(jnp.int32)
    dx = d5 // 9 - 1
    dy = (d5 // 3) % 3 - 1
    dz = d5 % 3 - 1
    u = (aux >> jnp.uint32(16)).astype(jnp.float32) / 65535.0
    prob = (aux & jnp.uint32(0xFFFF)).astype(jnp.float32) / 65535.0
    off = jnp.int32(1 << 18)
    vx = ((x - off).astype(jnp.float32) + u * dx) * voxel_size
    vy = ((y - off).astype(jnp.float32) + u * dy) * voxel_size
    vz = ((z - off).astype(jnp.float32) + u * dz) * voxel_size
    return vx, vy, vz, prob


@partial(
    jax.jit,
    static_argnames=("min_weight", "c_max"),
    donate_argnums=(2, 3, 4),
)
def _mesh_chunk(
    m: VoxelMap,
    bidx: jax.Array,
    buf_hi: jax.Array,  # [(cap + c_max) * 3] u32 flat, triangle-major
    buf_lo: jax.Array,
    buf_aux: jax.Array,
    offset: jax.Array,
    min_weight: float,
    c_max: int,
):
    """Triangulate one chunk of SURFACE blocks and append the valid
    triangles' packed vertex words into the (donated, in-place) global
    flat buffers at triangle `offset`.

    Compaction is a SORT + row-gather + contiguous append: valid
    triangle indices sort to the front (ascending, so triangle order is
    preserved), the 9 packed words per triangle arrive as one [c_max, 9]
    ROW gather (element gathers cost ~8.5 ns each on this chip; rows
    are ~1 ns/element), and one dynamic_update_slice per channel appends
    the run — sentinel-keyed in the invalid tail, which the next chunk's
    append overwrites.

    `c_max` must be >= the chunk's true triangle count (the census is
    exact, so the caller guarantees it; `_plan_chunks` also clamps it to
    the chunk-wide candidate bound); buffers carry c_max slack so the
    final append never clamps.
    """
    coords, (t9, p9, w9) = _halo_grids(
        m, bidx, [(m.tsdf, 1.0), (m.prob, 0.5), (m.weight, 0.0)]
    )
    base = coords * BLOCK_LEN

    valid, hi, lo, aux = _emit_chunk_packed(t9, p9, w9, base, min_weight)
    valid = valid & jnp.repeat(bidx >= 0, MAX_TRIS_PER_BLOCK)
    n_cand = valid.shape[0]
    rows = jnp.concatenate([hi, lo, aux], axis=1)  # [n_cand, 9]

    # valid candidate indices to the front, original order preserved
    skeys = jax.lax.sort(
        jnp.where(valid, jnp.arange(n_cand, dtype=jnp.int32), n_cand)
    )
    src = jax.lax.slice(skeys, (0,), (c_max,))
    ok = src < n_cand
    run = rows[jnp.minimum(src, n_cand - 1)]  # [c_max, 9] row gather
    run = jnp.where(ok[:, None], run, jnp.uint32(0xFFFFFFFF))

    off3 = offset * 3
    buf_hi = jax.lax.dynamic_update_slice(buf_hi, run[:, 0:3].reshape(-1), (off3,))
    buf_lo = jax.lax.dynamic_update_slice(buf_lo, run[:, 3:6].reshape(-1), (off3,))
    buf_aux = jax.lax.dynamic_update_slice(buf_aux, run[:, 6:9].reshape(-1), (off3,))
    offset = offset + jnp.sum(valid.astype(jnp.int32))
    return buf_hi, buf_lo, buf_aux, offset


def _emit_all_scan(m: VoxelMap, min_weight: float, chunk: int, c_max: int, cap: int):
    """Census-free, fully in-program emission: ONE `lax.scan` walks the
    whole (compacted) active-block list in `chunk`-block steps and
    appends packed triangle words — the jittable counterpart of the
    host-driven `extract_mesh` chunk loop, used inside the `shard_map`
    body of the parallel sharded export where no host orchestration is
    possible. Inactive chunks (the compacted tail) skip the emission
    math through `lax.cond`. Overflow beyond `c_max` per chunk or `cap`
    total is COUNTED, never silently dropped.

    Returns (buf_hi, buf_lo, buf_aux [3*(cap+c_max)], n_tris, overflow).
    """
    order, _ = _active_order(m)
    N = m.num_blocks
    n_chunks = -(-N // chunk)
    pad = n_chunks * chunk - N
    order_p = jnp.concatenate(
        [order, jnp.full((pad,), -1, jnp.int32)]
    ).reshape(n_chunks, chunk)
    sent = jnp.uint32(0xFFFFFFFF)
    M = (cap + c_max) * 3
    init = (
        jnp.full((M,), sent), jnp.full((M,), sent), jnp.full((M,), sent),
        jnp.int32(0), jnp.int32(0),
    )

    def step(carry, bidx):
        def emit(c):
            bh, bl, ba, off, oflow = c
            coords, (t9, p9, w9) = _halo_grids(
                m, bidx, [(m.tsdf, 1.0), (m.prob, 0.5), (m.weight, 0.0)]
            )
            base = coords * BLOCK_LEN
            valid, hi, lo, aux = _emit_chunk_packed(t9, p9, w9, base, min_weight)
            valid = valid & jnp.repeat(bidx >= 0, MAX_TRIS_PER_BLOCK)
            n_cand = valid.shape[0]
            rows = jnp.concatenate([hi, lo, aux], axis=1)
            skeys = jax.lax.sort(
                jnp.where(valid, jnp.arange(n_cand, dtype=jnp.int32), n_cand)
            )
            src = jax.lax.slice(skeys, (0,), (c_max,))
            okm = src < n_cand
            run = rows[jnp.minimum(src, n_cand - 1)]
            run = jnp.where(okm[:, None], run, sent)
            off3 = off * 3
            bh = jax.lax.dynamic_update_slice(bh, run[:, 0:3].reshape(-1), (off3,))
            bl = jax.lax.dynamic_update_slice(bl, run[:, 3:6].reshape(-1), (off3,))
            ba = jax.lax.dynamic_update_slice(ba, run[:, 6:9].reshape(-1), (off3,))
            cnt = jnp.sum(valid.astype(jnp.int32))
            kept = jnp.clip(jnp.minimum(cnt, c_max), 0, jnp.maximum(cap - off, 0))
            return bh, bl, ba, off + kept, oflow + cnt - kept

        return jax.lax.cond(jnp.any(bidx >= 0), emit, lambda c: c, carry), None

    (bh, bl, ba, off, oflow), _ = jax.lax.scan(step, init, order_p)
    return bh, bl, ba, off, oflow


def _plan_chunks(surf_idx, surf_counts, chunk):
    """Pad + reshape the census into per-chunk block lists and a
    power-of-two append width covering the peak chunk."""
    n_surf = len(surf_idx)
    n_chunks = max(1, (n_surf + chunk - 1) // chunk)
    pad = n_chunks * chunk - n_surf
    order = np.concatenate(
        [surf_idx, np.full(pad, -1, np.int32)]
    ).astype(np.int32).reshape(n_chunks, chunk)
    csum = np.concatenate(
        [surf_counts, np.zeros(pad, surf_counts.dtype if n_surf else np.int64)]
    ).reshape(n_chunks, chunk).sum(axis=1)
    peak = int(csum.max()) if n_chunks else 1
    c_max = 1 << max(12, (max(peak, 1) - 1).bit_length())
    # a chunk can never emit more than its candidate count (advisor r3:
    # the power-of-two rounding must not exceed the slice source)
    c_max = min(c_max, chunk * MAX_TRIS_PER_BLOCK)
    return order, c_max


DELTA_SENTINEL = -32768  # i16 marker: index delta out of range, take
#                          the next absolute value from the exception
#                          stream (|d| > 32767 can never collide: the
#                          sentinel value itself satisfies the test)


def _dedup_core(buf_hi, buf_lo, buf_aux, voxel_size: float):
    """Shared-vertex dedup + first-use renumbering + decode + transfer
    encoding (pure jaxpr — jitted as `_dedup_device`, and inlined into
    the `shard_map` body of the parallel sharded export).

    Inputs are flat [M] triangle-major vertex word streams (sentinel
    0xFFFFFFFF entries sort last). One 3-operand sort (hi, lo, iota)
    ranks duplicate edges together; every incident cube emitted
    bit-identical words for a shared edge, so the unique-vertex tables
    are plain value scatters through the inverse map (duplicate writers
    carry identical values — no representative selection needed).

    Vertex ids are then RE-NUMBERED in order of first appearance in the
    triangle stream. That makes the index stream delta-friendly — the
    emission scan walks cubes in lattice order, so consecutive indices
    reference vertices created moments ago — and the profile showed the
    index transfer (3 B/index at 17 MB/s) plus its host reassembly were
    ~2/3 of warm extraction time. Deltas ship as i16 (2 B/index) with a
    sentinel-marked absolute-value exception stream; the host rebuild is
    one numpy cumsum instead of a 3-byte splice (8.8 s -> ~0.3 s at the
    13.5M-triangle profile scale).

    Returns (xq/yq/zq [M] u16 AABB-quantized unique verts in first-use
    order, pq [M] u16, d16 [M] i16 index deltas, exc_vals [M//16] i32,
    n_exc, n_verts, aabb_lo [3] f32, aabb_scale [3] f32).
    """
    M = buf_hi.shape[0]
    iota = jnp.arange(M, dtype=jnp.int32)
    sent = (buf_hi == jnp.uint32(0xFFFFFFFF)) & (
        buf_lo == jnp.uint32(0xFFFFFFFF)
    )
    s_hi, s_lo, perm = jax.lax.sort((buf_hi, buf_lo, iota), num_keys=2)
    is_sent = (s_hi == jnp.uint32(0xFFFFFFFF)) & (
        s_lo == jnp.uint32(0xFFFFFFFF)
    )
    first = jnp.concatenate(
        [
            jnp.array([True]),
            (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1]),
        ]
    ) & ~is_sent
    uid_sorted = jnp.cumsum(first.astype(jnp.int32)) - 1
    n_verts = jnp.sum(first.astype(jnp.int32))
    inverse0 = jnp.zeros((M,), jnp.int32).at[perm].set(
        uid_sorted, mode="drop", unique_indices=True
    )

    # first-use renumbering: remap[old_uid] = rank of its first stream
    # position (valid stream entries precede the sentinel tail, so the
    # min over all positions is the first real use)
    first_pos = jnp.full((M,), M, jnp.int32).at[
        jnp.where(sent, M, inverse0)
    ].min(iota, mode="drop")
    _, uid_by_first = jax.lax.sort((first_pos, iota), num_keys=1)
    remap = jnp.zeros((M,), jnp.int32).at[uid_by_first].set(
        iota, mode="drop", unique_indices=True
    )
    inverse = remap[inverse0]

    dst = jnp.where(sent, M, inverse)
    u_hi = jnp.zeros((M,), jnp.uint32).at[dst].set(buf_hi, mode="drop")
    u_lo = jnp.zeros((M,), jnp.uint32).at[dst].set(buf_lo, mode="drop")
    u_aux = jnp.zeros((M,), jnp.uint32).at[dst].set(buf_aux, mode="drop")

    # index deltas + exceptions (exceptions are block-boundary refs to
    # long-ago vertices; measured ~1-3% of the stream)
    prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), inverse[:-1]])
    d = inverse - prev
    exc = (jnp.abs(d) > 32767) & ~sent
    d16 = jnp.where(sent, 0, jnp.where(exc, DELTA_SENTINEL, d)).astype(
        jnp.int16
    )
    exc_cap = M // 16
    exc_dst = jnp.where(exc, jnp.cumsum(exc.astype(jnp.int32)) - 1, exc_cap)
    exc_vals = jnp.zeros((exc_cap,), jnp.int32).at[exc_dst].set(
        inverse, mode="drop"
    )
    n_exc = jnp.sum(exc.astype(jnp.int32))

    vx, vy, vz, prob = _decode_vertices(u_hi, u_lo, u_aux, voxel_size)
    live = iota < n_verts
    big = jnp.float32(3.4e38)

    def aabb(c):
        return (
            jnp.min(jnp.where(live, c, big)),
            jnp.max(jnp.where(live, c, -big)),
        )

    lox, hix = aabb(vx)
    loy, hiy = aabb(vy)
    loz, hiz = aabb(vz)
    aabb_lo = jnp.stack([lox, loy, loz])
    aabb_scale = jnp.maximum(
        jnp.stack([hix - lox, hiy - loy, hiz - loz]), 1e-9
    )

    def q16(c, lo_, sc_):
        return jnp.clip(
            (c - lo_) / sc_ * 65535.0 + 0.5, 0, 65535
        ).astype(jnp.uint16)

    xq = q16(vx, lox, aabb_scale[0])
    yq = q16(vy, loy, aabb_scale[1])
    zq = q16(vz, loz, aabb_scale[2])
    pq = jnp.clip(prob * 65535.0 + 0.5, 0, 65535).astype(jnp.uint16)
    return xq, yq, zq, pq, d16, exc_vals, n_exc, n_verts, aabb_lo, aabb_scale


_dedup_device = partial(jax.jit, static_argnames=("voxel_size",),
                        donate_argnums=(0, 1, 2))(_dedup_core)


def extract_mesh(
    m: VoxelMap,
    cfg: TsdfConfig,
    min_weight: float = 1.5,
    chunk: int = 1024,
    max_tris: int = 1 << 23,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract the full mesh with shared-vertex compaction.

    Returns (vertices [V,3] f32, indices [T,3] i32, vertex_probs [V] f32).
    Every isosurface vertex lies on a unique voxel-grid edge; vertices
    are deduplicated by exact edge identity (sort-unique over packed
    endpoint keys — the same batch-dedup trick as block allocation), so
    V ~ T/2 like the reference's vertex-ownership + compaction scheme
    (`/root/reference/utils/tsdf/voxel_tsdf.cu:561-734`) instead of 3T.

    Pipeline: an exact census sizes the buffers to the measured surface
    (power-of-two buckets, so recompiles are rare); emission appends
    packed vertex WORDS only (no float geometry); dedup + position
    decode run on device; the host receives the already-compacted mesh.

    Host-transfer precision (the ~20 MB/s host link dominates wall time
    at scale): vertex positions ship as per-axis AABB-quantized u16
    (~0.2 mm at room scale — far below the 1 cm voxel), probabilities as
    u16 (1.5e-5 steps), indices as split u16/u8 words; outputs are
    reassembled as f32/int32 numpy in the reference's dump layout
    (`/root/reference/modules/tsdf_module.cc:66-86`).

    A surface beyond `max_tris` raises a clean ValueError instead of a
    device OOM.
    """
    surf_idx, surf_counts = _surface_census(m, min_weight)
    n = int(surf_counts.sum())
    if n == 0:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int32),
            np.zeros((0,), np.float32),
        )
    if n > max_tris:
        raise ValueError(
            f"mesh overflow: map surface has {n} triangles > "
            f"max_tris={max_tris}; raise the budget or raise min_weight"
        )
    order, c_max = _plan_chunks(surf_idx, surf_counts, chunk)
    cap = 1 << max(14, (n - 1).bit_length())
    cap = min(cap, max(max_tris, n))

    sent = jnp.uint32(0xFFFFFFFF)
    buf_hi = jnp.full(((cap + c_max) * 3,), sent)
    buf_lo = jnp.full(((cap + c_max) * 3,), sent)
    buf_aux = jnp.full(((cap + c_max) * 3,), sent)
    offset = jnp.int32(0)
    for c in range(order.shape[0]):
        buf_hi, buf_lo, buf_aux, offset = _mesh_chunk(
            m, jnp.asarray(order[c]), buf_hi, buf_lo, buf_aux, offset,
            min_weight, c_max,
        )

    # drop the append slack before dedup: everything past cap*3 is
    # sentinel tail (n <= cap), and dedup cost scales with the sort size
    (xq, yq, zq, pq, d16, exc_vals, _n_exc, n_verts_d, aabb_lo,
     aabb_scale) = _dedup_device(
        buf_hi[: cap * 3], buf_lo[: cap * 3], buf_aux[: cap * 3],
        cfg.voxel_size,
    )
    # Chunked transfer, queued BEFORE the n_verts sync so the index
    # stream is already riding the link while the host blocks on the
    # scalar; vertex slices dispatch after (their one post-readback
    # dispatch stall hides under the streaming index chunks). Chunk
    # boundaries are static multiples of _XFER_ELEMS, so the slice
    # programs compile once ever, with no pow2 padding of the payload.
    idx_ch = _stream_chunks(d16, 3 * n)
    for c in idx_ch:
        c.copy_to_host_async()
    v = int(n_verts_d)
    ne = int(_n_exc)  # second scalar off an already-synced program: ~free
    if ne > exc_vals.shape[0]:
        raise ValueError(
            f"mesh index exception stream overflow ({ne} > "
            f"{exc_vals.shape[0]}); the delta encoder's M//16 budget "
            "assumes <6% long-range refs"
        )
    # ONE pow2-rounded exception transfer (round-5 profile: 1.2M
    # exceptions at 1 cm voxels overflowed a fixed 128k prefetch and the
    # on-demand tail fetches serialized + recompiled — 21 s of 'link')
    exc_pref = exc_vals[: min(1 << max(16, (max(ne, 1) - 1).bit_length()),
                              exc_vals.shape[0])]
    exc_pref.copy_to_host_async()
    vert_ch = [_stream_chunks(a, v) for a in (xq, yq, zq, pq)]
    for chs in vert_ch:
        for c in chs:
            c.copy_to_host_async()

    # host: index reconstruction is one cumsum per chunk (replacing the
    # round-4 3-byte splice that cost 8.8 s of 2-core numpy at the
    # 13.5M-triangle profile point), overlapped with the link
    indices = _decode_index_stream(
        idx_ch, 3 * n, np.asarray(exc_pref), exc_vals
    ).reshape(-1, 3)

    lo_h = np.asarray(aabb_lo)
    sc_h = np.asarray(aabb_scale)
    vertices = np.empty((v, 3), np.float32)
    for k, chs in enumerate(vert_ch[:3]):
        vertices[:, k] = _cat_chunks(chs, v).astype(np.float32) * (
            sc_h[k] / 65535.0
        ) + lo_h[k]
    probs = _cat_chunks(vert_ch[3], v).astype(np.float32) / 65535.0

    # drop triangles degenerated by the dedup (two corners on one edge)
    nondeg = (
        (indices[:, 0] != indices[:, 1])
        & (indices[:, 1] != indices[:, 2])
        & (indices[:, 0] != indices[:, 2])
    )
    return vertices, indices[nondeg], probs


_XFER_ELEMS = 1 << 22  # elements per transfer slice


def _stream_chunks(a, need: int):
    """Static-boundary slices of `a` covering the first `need` elements."""
    k = max(1, -(-need // _XFER_ELEMS))
    return [
        a[i * _XFER_ELEMS : min((i + 1) * _XFER_ELEMS, a.shape[0])]
        for i in range(k)
    ]


def _cat_chunks(chs, need: int) -> np.ndarray:
    if len(chs) == 1:
        return np.asarray(chs[0])[:need]
    return np.concatenate([np.asarray(c) for c in chs])[:need]


def _decode_index_stream(idx_ch, need, exc_h, exc_dev) -> np.ndarray:
    """Rebuild i32 indices from i16 deltas + sentinel-marked absolute
    exceptions (inverse of the encoding in `_dedup_device`). Consumes
    the device chunks in queue order so reconstruction overlaps the
    still-streaming later chunks."""
    out = np.empty(need, np.int32)
    carry = np.int32(0)
    used_exc = 0
    off = 0
    for ch in idx_ch:
        dh = np.asarray(ch).astype(np.int32)
        L = min(len(dh), need - off)
        dh = dh[:L]
        pos = np.nonzero(dh == DELTA_SENTINEL)[0]
        if len(pos):
            dh[pos] = 0
        base = np.cumsum(dh, dtype=np.int32) + carry
        if len(pos):
            k1 = used_exc + len(pos)
            if k1 > len(exc_h):
                if k1 > exc_dev.shape[0]:
                    raise ValueError(
                        "mesh index exception stream overflow "
                        f"({k1} > {exc_dev.shape[0]}); the delta encoder's "
                        "M//16 budget assumes <6% long-range refs"
                    )
                exc_h = np.concatenate(
                    [exc_h, np.asarray(exc_dev[len(exc_h) : k1])]
                )
            corr = exc_h[used_exc:k1].astype(np.int32) - base[pos]
            offs = np.zeros(L, np.int32)
            lens = np.diff(np.append(pos, L))
            offs[pos[0] :] = np.repeat(corr, lens)
            base += offs
            used_exc = k1
        out[off : off + L] = base
        carry = base[-1] if L else carry
        off += L
    return out


def save_mesh(
    vertices: np.ndarray,
    indices: np.ndarray,
    probs: np.ndarray,
    vertices_path: str,
    indices_path: str,
    prob_path: str,
) -> None:
    """Write the reference's binary mesh dump format
    (`/root/reference/modules/tsdf_module.cc:66-86`)."""
    vertices.astype(np.float32).tofile(vertices_path)
    indices.astype(np.int32).tofile(indices_path)
    probs.astype(np.float32).tofile(prob_path)
