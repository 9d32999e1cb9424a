"""Smoke test of the system's main path on a GPU.

    python chip_smoke.py           # phases (a)-(c) on one card
    python chip_smoke.py --multi   # phase (a) + the four-card phase (d) only

(a) device: the default backend must be a GPU; prints the devices, the
    device kind and nvidia-smi's name and power limit. No CPU fallback.
(b) parity on the card against the plain reference on the CPU device of
    the same process: one integrate+carve step at the bench config on a
    map fused from the 60-frame VGA orbit, the Hamming matrix at
    1000 x 20000, the UNet forward with the demo weights at 480 x 640.
(c) main path: `offline_eval` on the 120-frame VGA orbit with tracking,
    the demo UNet and the 2^17-block map (track -> segment -> fuse ->
    mesh -> tsdf.bin -> ATE), then ~20 renders through the facade.
(d) --multi: the sharded map over a 4-card mesh against the one-card
    map, sharded against single-card meshing, and distributed against
    single-card bundle adjustment.

Every phase prints a line; any failure exits non-zero. The last line of
stdout is one JSON object: {"ok": true, "device": {...}}.
"""

import argparse
import dataclasses
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[+{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# the bench's TSDF configuration (bench.py main): VGA, 1 cm voxels, 6 cm
# truncation, a 2^17-block pool (~1.6 GB of payload), 8192 visible blocks
def bench_tsdf_config():
    from ra_slam_tpu.core.config import TsdfConfig

    return TsdfConfig(
        voxel_size=0.01, truncation=0.06, max_depth=6.0,
        log2_num_blocks=17, log2_hash_size=19,
        max_visible_blocks=1 << 13, max_shell_blocks=3072,
        max_new_blocks=1 << 13, width=640, height=480,
    )


def orbit(n_frames: int, width: int = 640, height: int = 480):
    from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    spec = SyntheticCameraSpec(
        fx=width / 2, fy=width / 2, cx=(width - 1) / 2, cy=(height - 1) / 2,
        width=width, height=height,
    )
    return SyntheticBoxDataset(
        num_frames=n_frames, cam=spec, half_extents=(3.0, 2.0, 3.0), radius=1.0
    )


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------


def phase_device(count: int):
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX found {jax.devices()})", file=sys.stderr)
        sys.exit(1)
    from ra_slam_tpu.utils.profiling import device_info

    devs = jax.devices()
    check(len(devs) >= count, f"need {count} GPUs, JAX found {len(devs)}")
    info = device_info()
    log(f"(a) device: {devs} kind={info['kind']}")
    log(f"(a) nvidia-smi: {info['nvidia_smi']}")
    return info


# ---------------------------------------------------------------------------
# (b) parity on the card against the CPU reference
# ---------------------------------------------------------------------------


def phase_parity(demo_model: str, cfg, ds) -> None:
    import jax
    import jax.numpy as jnp

    from ra_slam_tpu.core.se3 import SE3
    from ra_slam_tpu.features.matching import hamming_matrix, hamming_matrix_popcount
    from ra_slam_tpu.map.voxel_map import create_map, integrate_frame
    from ra_slam_tpu.models.segmentation import load_params, seg_probs

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    n = len(ds)
    cam = ds.camera
    frames = [ds.frame(i) for i in range(n)]

    def inputs(f, dev):
        """(rgb, depth, ht, lt, cam, cam_T_world) on `dev`."""
        return jax.device_put((
            jnp.asarray(f.rgb, jnp.float32), jnp.asarray(f.depth),
            jnp.asarray(f.ht), jnp.asarray(f.lt), cam,
            SE3.from_matrix(jnp.asarray(f.cam_T_world)),
        ), dev)

    step = functools.partial(integrate_frame, cfg=cfg, alloc_stride=3)
    fuse = jax.jit(step, donate_argnums=(0,))
    m = jax.device_put(create_map(cfg), gpu)
    for f in frames[:-1]:
        m, stats = fuse(m, *inputs(f, gpu))
    check(int(stats["alloc_failures"]) == 0, "allocation overflow while fusing")
    m_cpu = jax.device_put(m, cpu)
    one = jax.jit(step)  # not donated: both copies are compared below
    out_g, st_g = one(m, *inputs(frames[-1], gpu))
    out_c, _ = one(m_cpu, *inputs(frames[-1], cpu))
    out_g, out_c = jax.device_get((out_g, out_c))
    failures = []
    keys_equal = bool((out_g.block_key == out_c.block_key).all())
    active_equal = bool((out_g.active == out_c.active).all())
    if not (keys_equal and active_equal):
        failures.append("block_key or active differs")
    rows = np.asarray(out_g.active)
    n_vox = int(rows.sum()) * 512
    # A voxel whose projection lands within float32 rounding of a pixel
    # boundary can sample the neighbouring pixel on one backend (the two
    # round the projection matmul differently). That moves its range
    # scale by up to ~1e-2 relative and its tsdf by up to ~1e-3. Such
    # voxels are allowed, up to 1 in 10^5; every other voxel holds the
    # tolerance.
    summary = {}
    for k, tol in (("tsdf", 1e-5), ("weight", 1e-5), ("prob", 1e-4), ("rgb", 1e-3)):
        err = np.abs(np.asarray(getattr(out_g, k))[rows].astype(np.float64)
                     - np.asarray(getattr(out_c, k))[rows])
        n_over, worst = int((err > tol).sum()), float(err.max())
        summary[k] = (worst, n_over)
        if n_over > n_vox // 100000 or worst > 100 * tol:
            failures.append(f"integrate {k}: {n_over} voxels beyond {tol}, max {worst}")
    log(f"(b) integrate+carve, frame {n - 1} on a {n - 1}-frame map: "
        f"{int(st_g['num_active'])} active ({n_vox} voxels), "
        f"{int(st_g['num_visible'])} visible, keys/active equal {keys_equal}/"
        f"{active_equal}, (max |gpu - cpu|, voxels beyond tol) {summary}")
    del m, m_cpu, out_g, out_c

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (1000, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (20000, 8), dtype=np.uint32)
    d_gpu = np.asarray(jax.jit(hamming_matrix)(jax.device_put(a, gpu), jax.device_put(b, gpu)))
    d_cpu = np.asarray(jax.jit(hamming_matrix_popcount)(jax.device_put(a, cpu), jax.device_put(b, cpu)))
    n_diff = int((d_gpu != d_cpu).sum())
    if n_diff:
        failures.append(f"hamming: {n_diff} entries differ from the popcount reference")
    log(f"(b) hamming 1000x20000: {n_diff} entries differ from the CPU popcount reference")

    params = load_params(demo_model)
    x = jnp.asarray(frames[0].rgb, jnp.float32)[None] / 255.0
    ht_g, lt_g = jax.jit(seg_probs)(jax.device_put(params, gpu), jax.device_put(x, gpu))
    # The reference runs op by op: under jit the CPU backend computes the
    # bf16 convolutions in float32 throughout, while the card rounds every
    # activation to bf16 as the net specifies; eager CPU rounds each op's
    # output to bf16 too. bf16 rounding alone moves single pixels near the
    # ht/lt decision boundary by up to ~0.1 (CPU: eager bf16 against
    # float32 differs by 0.005 on average, 0.088 at most, at 480x640), so
    # the 2e-2 bound holds for the mean and the decisions must agree.
    with jax.default_device(cpu):
        ht_c, lt_c = seg_probs(jax.device_put(params, cpu), jax.device_put(x, cpu))
    err = np.abs(np.asarray(ht_g, np.float64) - np.asarray(ht_c))
    agree = float(np.mean((np.asarray(ht_g) > 0.5) == (np.asarray(ht_c) > 0.5)))
    dl = max_abs(lt_g, lt_c)
    log(f"(b) unet 480x640 demo weights: |gpu - cpu| ht mean {err.mean():.3g} "
        f"p99.9 {np.quantile(err, 0.999):.3g} max {err.max():.3g}, lt max {dl:.3g}; "
        f"ht > 0.5 agrees on {agree:.5f} of pixels")
    if err.mean() > 2e-2 or agree < 0.99:
        failures.append("unet ht/lt differ from the CPU reference")
    check(not failures, "; ".join(failures))


# ---------------------------------------------------------------------------
# (c) main path through the offline CLI and the facade
# ---------------------------------------------------------------------------


def phase_main_path(demo_model: str, smi: str, extra=()) -> None:
    import jax.numpy as jnp

    from ra_slam_tpu.core.se3 import SE3
    from ra_slam_tpu.pipeline import offline_eval

    with tempfile.TemporaryDirectory() as out:
        res, system = offline_eval.run([
            "--synthetic", "--use-slam", "--model", demo_model, "--download", out,
            *extra,
        ])
    log(f"(c) offline_eval: {json.dumps(res)}")
    n = res["frames_in"]
    check(res["tracked"] >= n - 1, f"tracked {res['tracked']} of {n} frames")
    check(res["frames"] == res["tracked"], "a tracked frame was not integrated")
    check(res["alloc_failures"] == 0, "allocation failures in the main path")
    check(res["ate"]["ate_rmse"] < 0.05, f"ATE {res['ate']['ate_rmse']} m >= 5 cm")
    check(res["mesh_triangles"] > 0, "empty mesh")
    check(res["tsdf_rows"] > 0, "empty tsdf dump")

    # render along the orbit at the poses the system tracked: the map
    # lives in the tracker's world frame, not the dataset's
    coverage = []
    for fid, cam_T_world in system.slam.trajectory()[::6]:
        pose = SE3.from_matrix(jnp.asarray(np.vstack([cam_T_world, [0, 0, 0, 1]]), jnp.float32))
        r = system.render(pose)
        check(int(r["dropped_splats"]) == 0, f"render {fid} dropped splats")
        check(bool(jnp.isfinite(r["depth"]).all()), f"render {fid} non-finite depth")
        coverage.append(float((r["depth"] > 0).mean()))
    log(f"(c) rendered {len(coverage)} tracked orbit poses, no dropped splats; "
        f"pixel coverage {min(coverage):.3f}-{max(coverage):.3f}")
    check(min(coverage) > 0.5, "a render is mostly empty")
    log(f"(c) main path {n} frames: {res['fps']:.2f} fps, wall {res['wall_s']:.2f} s "
        f"on {smi}")


# ---------------------------------------------------------------------------
# (d) four cards: sharded map, sharded meshing, distributed BA
# ---------------------------------------------------------------------------


def ba_problem(num_kf=8, num_pts=2048, seed=0):
    """A window of `num_kf` keyframes observing `num_pts` landmarks,
    perturbed from ground truth (keyframe 0 exact: the gauge anchor)."""
    import jax.numpy as jnp

    from ra_slam_tpu.core.camera import PinholeCamera
    from ra_slam_tpu.core.se3 import SE3, exp_se3
    from ra_slam_tpu.slam.keyframes import create_keyframes, insert_keyframe
    from ra_slam_tpu.slam.landmarks import create_landmarks

    rng = np.random.default_rng(seed)
    cam = PinholeCamera.create(320.0, 320.0, 319.5, 239.5, 640, 480)
    pts = np.stack([rng.uniform(-2, 2, num_pts), rng.uniform(-1.5, 1.5, num_pts),
                    rng.uniform(3, 6, num_pts)], -1).astype(np.float32)
    kfs = create_keyframes(capacity=16, num_features=num_pts)
    lms = create_landmarks(4096)
    lms = lms._replace(pos=lms.pos.at[:num_pts].set(jnp.asarray(pts)),
                       valid=lms.valid.at[:num_pts].set(True))
    obs_lm = jnp.arange(num_pts, dtype=jnp.int32)
    for k in range(num_kf):
        pose = exp_se3(jnp.asarray([0, 0.03 * k, 0, 0.15 * k, 0, 0], jnp.float32))
        uv, z = cam.project(pose.apply(jnp.asarray(pts)))
        w = (z > 0).astype(jnp.float32) * cam.in_bounds(uv)
        kfs = insert_keyframe(kfs, jnp.int32(k), pose, jnp.int32(k),
                              jnp.float32(k / 30.0), obs_lm, uv, w,
                              jnp.zeros((num_pts, 8), jnp.uint32))
    for k in range(1, num_kf):
        xi = rng.normal(0, 0.02, 6).astype(np.float32)
        noisy = exp_se3(jnp.asarray(xi)) @ SE3(kfs.R[k], kfs.t[k])
        kfs = kfs._replace(R=kfs.R.at[k].set(noisy.R), t=kfs.t.at[k].set(noisy.t))
    noise = rng.normal(0, 0.05, (num_pts, 3)).astype(np.float32)
    lms = lms._replace(pos=lms.pos.at[:num_pts].add(jnp.asarray(noise)))
    return cam, kfs, lms, num_kf


def phase_multi(n_dev: int, cfg, ds) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ra_slam_tpu.core.se3 import SE3
    from ra_slam_tpu.map import voxel_map as vm
    from ra_slam_tpu.map.meshing import extract_mesh
    from ra_slam_tpu.parallel import (
        create_sharded_map, distributed_bundle_adjustment, make_sharded_integrate_step,
    )
    from ra_slam_tpu.parallel.sharded_map import extract_mesh_sharded, make_gather_shards
    from ra_slam_tpu.slam.ba import local_bundle_adjustment

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("map",))
    # Twice the bench's visible-block cap: 3 frames of the 60-frame orbit
    # see up to 8395 blocks, and a capped one-card run skips the excess
    # (the count is checked below), so the maps would differ by work not
    # done rather than by sharding. Every shard keeps the one-card
    # per-frame capacities.
    cfg = dataclasses.replace(cfg, max_visible_blocks=2 * cfg.max_visible_blocks)
    scfg = dataclasses.replace(
        cfg, max_visible_blocks=cfg.max_visible_blocks * n_dev,
        max_new_blocks=cfg.max_new_blocks * n_dev,
    )
    n = len(ds)
    cam = ds.camera
    frames = [ds.frame(i) for i in range(n)]
    step_s = make_sharded_integrate_step(mesh, scfg, alloc_stride=3, owner_mode="slab")
    step_1 = jax.jit(functools.partial(vm.integrate_frame, cfg=cfg, alloc_stride=3),
                     donate_argnums=(0,))
    ms = create_sharded_map(scfg, mesh)
    m1 = vm.create_map(cfg)
    max_visible = 0
    for f in frames:
        args = (jnp.asarray(f.rgb, jnp.float32), jnp.asarray(f.depth),
                jnp.asarray(f.ht), jnp.asarray(f.lt))
        pose = SE3.from_matrix(jnp.asarray(f.cam_T_world))
        ms, st_s = step_s(ms, *args, cam, pose)
        m1, st_1 = step_1(m1, *args, cam, pose)
        max_visible = max(max_visible, int(st_1["num_visible"]))
    log(f"(d) sharded integrate x{n_dev}, {n} frames: {int(st_s['num_active'])} active "
        f"vs one card {int(st_1['num_active'])}; at most {max_visible} visible blocks")
    check(max_visible <= cfg.max_visible_blocks, "visible blocks overflow the cap")
    check(int(st_s["alloc_failures"]) == 0 and int(st_1["alloc_failures"]) == 0,
          "allocation overflow")
    check(int(st_s["num_active"]) == int(st_1["num_active"]), "num_active differs")

    gather, gcfg = make_gather_shards(mesh, scfg)
    mg, dropped = gather(ms)
    check(int(dropped) == 0, "gather dropped blocks")

    def rows(m, c):
        r = vm.gather_valid_semantic(jax.device_get(m), c)
        return r[np.lexsort((r[:, 2], r[:, 1], r[:, 0]))]

    a, b = rows(mg, gcfg), rows(m1, cfg)
    check(a.shape == b.shape, f"gathered map has {a.shape} rows, one card {b.shape}")
    check(max_abs(a[:, :3], b[:, :3]) == 0.0, "voxel positions differ")
    # the phase (b) rule: every voxel within tolerance but for rounding-tie
    # voxels (at most 1 in 10^5), which the two programs may resolve to
    # neighbouring pixels; over 60 frames such a voxel can sit on a depth
    # edge, so its difference is not bounded
    failures = []
    summary = {}
    for k, col, tol in (("tsdf", 3, 1e-5), ("prob", 4, 1e-4)):
        err = np.abs(a[:, col].astype(np.float64) - b[:, col])
        summary[k] = (float(err.max()), int((err > tol).sum()), int((err > 1e-3).sum()))
        if summary[k][1] > len(a) // 100000:
            failures.append(f"gathered map {k}: {summary[k][1]} voxels beyond {tol}")
    log(f"(d) gathered map vs one card: {len(a)} voxels, "
        f"(max |d|, voxels beyond tol, beyond 1e-3) {summary}")

    _, t_g, _ = extract_mesh(mg, gcfg)
    _, t_1, _ = extract_mesh(m1, cfg)
    # per-shard emission budget: room for the whole one-card mesh
    _, t_s, _, info = extract_mesh_sharded(
        ms, mesh, scfg, cap_shard=1 << max(14, int(len(t_1)).bit_length())
    )
    log(f"(d) sharded mesh {len(t_s)} triangles, the gathered map meshed on one "
        f"card {len(t_g)}, the one-card map {len(t_1)} "
        f"(peak {info['peak_blocks_per_shard']} blocks/shard)")
    if info["dropped"] or len(t_s) != len(t_g) or not len(t_s):
        failures.append("sharded mesh differs from meshing the gathered map")
    if abs(len(t_s) - len(t_1)) > len(t_1) // 10000:
        failures.append("sharded mesh differs from the one-card mesh")
    del ms, m1, mg

    cam_ba, kfs, lms, num_kf = ba_problem()
    kfc = jnp.int32(num_kf)
    bmesh = Mesh(np.array(jax.devices()[:n_dev]), ("ba",))
    _, _, st_l = jax.jit(lambda k, l: local_bundle_adjustment(
        k, l, kfc, cam_ba, window=8, max_points=2048, iterations=8))(kfs, lms)
    _, _, st_d = jax.jit(lambda k, l: distributed_bundle_adjustment(
        k, l, kfc, cam_ba, bmesh, window=8, max_points=2048, iterations=8))(kfs, lms)
    r_l, r_d = float(st_l.rmse_after), float(st_d.rmse_after)
    log(f"(d) bundle adjustment rmse {float(st_l.rmse_before):.4g} -> one card "
        f"{r_l:.4g} px, distributed x{n_dev} {r_d:.4g} px")
    if not (np.isfinite(r_d) and abs(r_d - r_l) <= 1e-2 + 1e-2 * r_l):
        failures.append("distributed BA rmse differs from the one-card solve")
    check(not failures, "; ".join(failures))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card phase (d)")
    args = p.parse_args(argv)

    info = phase_device(4 if args.multi else 1)
    smi = info["nvidia_smi"]
    demo = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ra_slam_tpu", "models", "demo_seg.npz")
    if args.multi:
        phase_multi(4, bench_tsdf_config(), orbit(60))
    else:
        phase_parity(demo, bench_tsdf_config(), orbit(60))
        phase_main_path(demo, smi)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        k: info[k] for k in ("platform", "kind", "count")
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
