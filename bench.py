"""Headline benchmark suite on one chip.

Primary metric (the driver's JSON line): TSDF-fused frames/s, mirroring
the reference's metric path (`/root/reference/main/offline_eval.cc:54-57`:
640x480 RGB-D fusion, 1 cm voxels, 6 cm truncation). Target
(BASELINE.json north star): >= 30 fused frames/s/chip.

The same line carries the whole-system numbers the reference only
instruments (BASELINE.md): tracked-SLAM frames/s (detect + track + BA on
the device), raycast frames/s at 640x480, mesh-extraction wall time, and
descriptor-matching latency.

Needs a GPU: with no GPU it exits non-zero and prints no result. Every
result names the device it ran on (platform, device_kind, count, and
nvidia-smi's name and power limit).

Prints ONE JSON line:
  {"metric": "fused_frames_per_sec_per_chip", "value": N,
   "unit": "frames/s", "vs_baseline": N/30, "extra": {...}}
"""

import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


_sync = jax.block_until_ready


def _mark(msg):
    """Progress marker on stderr (stdout stays one JSON line)."""
    print(f"[bench +{time.monotonic() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


_T0 = time.monotonic()


def bench_fusion(frames, cam, poses, cfg):
    from ra_slam_tpu.map.voxel_map import create_map, integrate_frame

    rgbs = [jnp.asarray(f.rgb, jnp.float32) for f in frames]
    depths = [jnp.asarray(f.depth) for f in frames]
    hts = [jnp.asarray(f.ht) for f in frames]
    lts = [jnp.asarray(f.lt) for f in frames]

    # allocation samples every 3rd pixel: ray spacing at the 6 m depth
    # cap is 3 px * 6 m / 320 fx = 5.6 cm < the 8 cm block size, so no
    # crossed block is skipped (the active-block count stays within
    # 0.13% of stride 2, with no allocation failures)
    step = jax.jit(
        functools.partial(integrate_frame, cfg=cfg, alloc_stride=3),
        donate_argnums=(0,),
    )
    # first call compiles (or loads from the persistent compile cache)
    t0 = time.perf_counter()
    m = create_map(cfg)
    m, stats = step(m, rgbs[0], depths[0], hts[0], lts[0], cam, poses[0])
    _sync(m)
    compile_s = time.perf_counter() - t0

    m = create_map(cfg)
    t0 = time.perf_counter()
    for i in range(len(frames)):
        m, stats = step(m, rgbs[i], depths[i], hts[i], lts[i], cam, poses[i])
    _sync(m)
    dt = time.perf_counter() - t0
    assert int(stats["alloc_failures"]) == 0, "allocation overflow during bench"
    return len(frames) / dt, m, compile_s, step


def bench_tracking(ds, n_frames):
    """Full sparse-SLAM rate: ORB detect + track + keyframes + loops.

    Frames are PRE-STAGED as device arrays before the timed loop, like
    the fusion bench, so the host feed (PCIe upload) is not in this
    number. VGA x 1000 keypoints, the reference's live envelope
    (`/root/reference/cameras/l515.h:43-47`).
    """
    from ra_slam_tpu.core.config import FeatureConfig, TrackingConfig
    from ra_slam_tpu.slam.system import SlamSystem

    sys_ = SlamSystem(
        ds.camera,
        fcfg=FeatureConfig(max_num_keypoints=1000, num_levels=4),
        tcfg=TrackingConfig(min_inliers=15, match_radius=30.0),
        ba_window=6, ba_max_points=2048, ba_iterations=5,
    )
    frames = [ds.frame(i) for i in range(n_frames)]
    dev = [
        (
            jax.device_put(np.asarray(f.rgb, np.uint8)),
            jax.device_put(np.asarray(f.depth, np.float32)),
        )
        for f in frames
    ]
    _sync(dev)
    # warmup: the fused frame step compiles every branch on first call
    for rgb, depth in dev[:3]:
        sys_.feed_rgbd_frame(rgb, depth, 0.0).block()
    t0 = time.perf_counter()
    infos = [
        sys_.feed_rgbd_frame(rgb, depth, i / 30.0, frame_id=i)
        for i, (rgb, depth) in enumerate(dev[3:], 3)
    ]
    infos[-1].block()  # one sync at the end: timing covers all dispatches
    dt = time.perf_counter() - t0
    tracked = sum(int(i.tracked) for i in infos)
    assert tracked == n_frames - 3, f"tracking lost ({tracked})"
    return (n_frames - 3) / dt, sys_


def bench_raycast(m, cam, poses, cfg):
    """Chained renders sweeping ALL orbit poses (shell occupancy,
    visibility compaction and sort size vary per pose — a fixed-pose
    loop would hide pose sensitivity), one end sync — the same shape as
    the fusion loop. Returns (fps, jitted raycast fn)."""
    from ra_slam_tpu.map.raycast import raycast

    rc = jax.jit(functools.partial(raycast, cam=cam, cfg=cfg))
    out = rc(m, cam_T_world=poses[0])
    assert int(_sync(out["dropped_splats"])) == 0, "shell-block overflow"
    t0 = time.perf_counter()
    for pose in poses:
        out = rc(m, cam_T_world=pose)
    _sync(out)
    fps = len(poses) / (time.perf_counter() - t0)
    assert int(_sync(out["dropped_splats"])) == 0, "shell overflow in sweep"
    return fps, rc


def bench_meshing(m, cfg):
    from ra_slam_tpu.map.meshing import extract_mesh

    # the 168 m^2 box at 1 cm voxels measures ~7.3M marching-tetrahedra
    # triangles; budget one power of two above (sized-to-count buffers
    # keep actual memory proportional to the measured surface).
    # One warmup pass triggers the XLA compiles (the reference's CUDA
    # mesh kernels are compiled at build time; every other metric in
    # this suite also excludes compilation) — the timed pass is the
    # steady-state button-press latency. Cold time is reported too.
    t0 = time.perf_counter()
    verts, idx, probs = extract_mesh(m, cfg, max_tris=1 << 23)
    cold = time.perf_counter() - t0
    # MEDIAN of three warm passes (`min` would drift toward the best
    # case; the median is the steady-state latency)
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        verts, idx, probs = extract_mesh(m, cfg, max_tris=1 << 23)
        dts.append(time.perf_counter() - t0)
    return sorted(dts)[1], cold, len(verts), len(idx), dts


def bench_seg(iters=40):
    """UNet ht/lt inference latency at the TSDF feed resolution, bf16
    compute (the reference measures per-frame inference in-pipeline,
    `/root/reference/segmentation/inference.cc:84-88`, and benches it
    standalone, `examples/segmentation_inference/main.cc:48-60`).
    Returns (latency_ms, seg_step, params) — the jitted step is reused
    by the whole-system bench so its compile is paid once."""
    from ra_slam_tpu.models.segmentation import InferenceEngine, seg_probs

    eng = InferenceEngine("__random__", width=640, height=480)

    @jax.jit
    def seg_step(params, rgbf):
        ht, lt = seg_probs(params, rgbf[None] * (1.0 / 255.0))
        return ht[0], lt[0]

    rng = np.random.default_rng(1)
    rgbf = jnp.asarray(rng.uniform(0, 255, (480, 640, 3)), jnp.float32)
    ht, lt = seg_step(eng.params, rgbf)
    _sync(ht)
    t0 = time.perf_counter()
    for _ in range(iters):
        ht, lt = seg_step(eng.params, rgbf)
    _sync(ht)
    return (time.perf_counter() - t0) / iters * 1e3, seg_step, eng.params


def bench_system(
    slam, seg_step, seg_params, integrate_step, cfg,
    orbit_frames=240, n_frames=206,
):
    """WHOLE-SYSTEM concurrent throughput: every frame runs ORB detect +
    fused SLAM step + UNet segmentation + TSDF integration with the
    TRACKED pose (not GT), plus a raycast render every 3rd frame — all
    on the one chip, chained, one end sync. This is the reference's
    live operating point (`/root/reference/main/live_camera.cc:16-38`:
    SLAM thread + seg->TSDF thread + render loop live simultaneously);
    where the reference overlaps threads on independent GPU streams, here
    XLA's async dispatch queues all four stages per frame and the device
    executes them back-to-back.

    Frames are pre-staged (bench convention: the host feed is not in
    this number); the timed span covers ONE orbit so the background
    loop-closure/PGO/GBA handlers (host-triggered, compile-on-first-use)
    stay out of a *throughput* measurement — their behavior is the EVAL
    artifact's job. Compiled steps are all reused from the per-stage
    benches; the SLAM system is state-reset, keeping its jits.
    """
    import dataclasses

    from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
    from ra_slam_tpu.map.raycast import raycast
    from ra_slam_tpu.map.voxel_map import create_map

    # feed 206 of a 240-frame orbit: the timed span stays ~50 degrees
    # short of the revisit (same margin as the tracking bench), keeping
    # the host-triggered closure handlers out of the throughput window
    ds = SyntheticBoxDataset(
        num_frames=orbit_frames,
        cam=SyntheticCameraSpec(
            fx=320.0, fy=320.0, cx=319.5, cy=239.5, width=640, height=480
        ),
        radius=1.0,
    )
    cam = ds.camera
    slam.reset()
    frames = [ds.frame(i) for i in range(n_frames)]
    rgb8 = [jax.device_put(np.asarray(f.rgb, np.uint8)) for f in frames]
    depths = [jax.device_put(np.asarray(f.depth, np.float32)) for f in frames]
    to_f32 = jax.jit(lambda x: x.astype(jnp.float32))
    rgbf = [to_f32(r) for r in rgb8]
    _sync(rgbf)

    # the 206-frame map holds ~3.4x more weight updates than the
    # 60-frame fusion map, so far more grazing-angle blocks clear
    # raycast_min_weight into the renderable shell: the in-system
    # renderer gets its own (larger) shell budget, overflow still
    # asserted zero
    rc = jax.jit(functools.partial(
        raycast, cam=cam,
        cfg=dataclasses.replace(cfg, max_shell_blocks=cfg.max_visible_blocks),
    ))

    m = create_map(cfg)
    infos = []
    ren = None
    for i in range(3):  # warmup: first-call branches + pose bootstrap
        info = slam.feed_rgbd_frame(rgb8[i], depths[i], i / 30.0, frame_id=i)
        info.block()
        ht, lt = seg_step(seg_params, rgbf[i])
        m, stats = integrate_step(m, rgbf[i], depths[i], ht, lt, cam, info.pose)
    ren = rc(m, cam_T_world=info.pose)  # compile the renderer pre-loop
    _sync((m, ren))

    def span(render: bool):
        slam.reset()
        m = create_map(cfg)
        infos, ren = [], None
        for i in range(3):
            info = slam.feed_rgbd_frame(rgb8[i], depths[i], i / 30.0, frame_id=i)
            info.block()
            ht, lt = seg_step(seg_params, rgbf[i])
            m2, stats = integrate_step(m, rgbf[i], depths[i], ht, lt, cam, info.pose)
            m = m2
        _sync(m)
        t0 = time.perf_counter()
        for i in range(3, n_frames):
            info = slam.feed_rgbd_frame(rgb8[i], depths[i], i / 30.0, frame_id=i)
            infos.append(info)
            ht, lt = seg_step(seg_params, rgbf[i])
            m, stats = integrate_step(m, rgbf[i], depths[i], ht, lt, cam, info.pose)
            if render and i % 3 == 0:
                ren = rc(m, cam_T_world=info.pose)
        infos[-1].block()
        alloc_failures = int(_sync(stats["alloc_failures"]))
        dt = time.perf_counter() - t0
        tracked = sum(int(i.tracked) for i in infos)
        n_timed = n_frames - 3
        assert tracked == n_timed, f"system bench lost frames ({tracked}/{n_timed})"
        assert alloc_failures == 0, "allocation overflow in system bench"
        if ren is not None:
            assert int(_sync(ren["dropped_splats"])) == 0, (
                "shell overflow in system bench"
            )
        return n_timed / dt

    # The no-render rate is the camera-rate pipeline: the reference
    # decouples its renderer into a best-effort GUI loop
    # (renderer_module.cc:55-70) while tracking+fusion run at camera
    # rate.
    fps_no_render = span(render=False)
    fps = span(render=True)
    return fps, fps_no_render


def bench_matching(iters=30):
    """Hamming-matrix latency, 1000 query x 20000 database descriptors
    (tracking + loop-retrieval hot op)."""
    from ra_slam_tpu.features.matching import hamming_matrix

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 2**32, (1000, 8), dtype=np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, (20000, 8), dtype=np.uint32))
    fn = jax.jit(hamming_matrix)
    out = fn(a, b)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(a, b)
    _sync(out)
    return (time.perf_counter() - t0) / iters * 1e3  # ms


def main():
    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.devices()}", file=sys.stderr)
        sys.exit(1)
    from ra_slam_tpu.utils.profiling import device_info

    device = device_info()
    from ra_slam_tpu.core.config import TsdfConfig
    from ra_slam_tpu.core.se3 import SE3
    from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    n_frames = 60
    spec = SyntheticCameraSpec(
        fx=320.0, fy=320.0, cx=319.5, cy=239.5, width=640, height=480
    )
    ds = SyntheticBoxDataset(
        num_frames=n_frames, cam=spec, half_extents=(3.0, 2.0, 3.0), radius=1.0
    )
    cfg = TsdfConfig(
        voxel_size=0.01,
        truncation=0.06,
        max_depth=6.0,
        log2_num_blocks=17,
        log2_hash_size=19,
        # the orbit views measure ~6.3k visible blocks; the cap sizes
        # every per-visible-block working set (integrate + raycast)
        max_visible_blocks=1 << 13,
        # ~2.1k visible blocks hold shell voxels at the render poses of
        # the 60-frame fusion map (0 drops across the 60-pose sweep);
        # the whole-system bench renders the RICHER 206-frame map and
        # sizes its own renderer's budget (bench_system)
        max_shell_blocks=3072,
        # the heaviest frame allocates ~5k new blocks; 8192 bounds the
        # alloc sort/lookup windows (overflow counted, asserted 0)
        max_new_blocks=1 << 13,
        width=640,
        height=480,
    )
    cam = ds.camera
    frames = [ds.frame(i) for i in range(n_frames)]
    poses = [SE3.from_matrix(jnp.asarray(f.cam_T_world)) for f in frames]

    _mark("fusion: compile + 60 frames")
    fused_fps, m, compile_s, integrate_step = bench_fusion(
        frames, cam, poses, cfg
    )
    _mark(f"fusion done ({fused_fps:.1f} f/s); raycast")
    raycast_fps, rc = bench_raycast(m, cam, poses, cfg)
    _mark(f"raycast done ({raycast_fps:.1f} f/s, 60-pose sweep); meshing")
    mesh_s, mesh_cold_s, n_verts, n_tris, mesh_all = bench_meshing(m, cfg)
    _mark(
        f"meshing done ({mesh_s:.2f}s warm median of "
        f"{[round(d, 2) for d in mesh_all]}, {mesh_cold_s:.1f}s cold); matching"
    )
    match_ms = bench_matching()
    _mark(f"matching done ({match_ms:.2f} ms); tracking")

    track_ds = SyntheticBoxDataset(
        num_frames=120,
        cam=SyntheticCameraSpec(
            fx=320.0, fy=320.0, cx=319.5, cy=239.5, width=640, height=480
        ),
        radius=1.0,
    )
    slam_fps, slam = bench_tracking(track_ds, 103)
    _mark(f"tracking done ({slam_fps:.1f} f/s); segmentation")
    seg_ms, seg_step, seg_params = bench_seg()
    _mark(f"segmentation done ({seg_ms:.2f} ms); whole system")
    system_fps, system_fps_nr = bench_system(
        slam, seg_step, seg_params, integrate_step, cfg
    )
    _mark(f"whole system done ({system_fps:.1f} f/s, {system_fps_nr:.1f} no-render)")

    extra = {
        "system_fps_640x480": round(system_fps, 2),
        "system_fps_no_render_640x480": round(system_fps_nr, 2),
        "tracked_slam_fps_640x480": round(slam_fps, 2),
        "raycast_fps_640x480": round(raycast_fps, 2),
        "seg_latency_ms": round(seg_ms, 3),
        "mesh_extract_s": round(mesh_s, 3),
        "mesh_extract_warm_all_s": [round(d, 3) for d in mesh_all],
        "mesh_extract_cold_s": round(mesh_cold_s, 2),
        "mesh_vertices": n_verts,
        "mesh_triangles": n_tris,
        "hamming_1000x20000_ms": round(match_ms, 3),
        # time to the first fused frame: compile, or a load when the
        # persistent compile cache holds this program
        "fusion_compile_s": round(compile_s, 1),
    }
    print(f"device: {device['nvidia_smi']}", file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "fused_frames_per_sec_per_chip",
                "value": round(fused_fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fused_fps / 30.0, 3),
                "extra": extra,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
