"""Multi-device / multi-host fusion scaling benchmark.

Measures TSDF-fused frames/s of the sharded integrate step over the
global mesh (all devices of all processes) and, in single-process mode,
the 1-device baseline — reporting the scaling efficiency BASELINE.md
asks for (target: >= 70 % at >= 2 hosts).

Single process (n local/virtual devices):
    python -m ra_slam_tpu.pipeline.bench_scaling --devices 8

Spawn a local multi-process (gloo) demo, 2 hosts x 4 virtual devices:
    python -m ra_slam_tpu.pipeline.bench_scaling --spawn 2 --devices 4

Spawn one process per GPU (each child sees only its own card):
    python -m ra_slam_tpu.pipeline.bench_scaling --spawn 4

Real multi-host: run once per host with RA_SLAM_COORDINATOR /
RA_SLAM_NUM_PROCESSES / RA_SLAM_PROCESS_ID exported.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time


def _bench_mesh(mesh, cfg, frames, cam, poses, replicate) -> float:
    import jax

    from ra_slam_tpu.parallel.sharded_map import (
        create_sharded_map,
        make_sharded_integrate_step,
    )

    m = create_sharded_map(cfg, mesh)
    step = make_sharded_integrate_step(mesh, cfg, alloc_stride=2)
    args0 = [replicate(a) for a in frames[0]]
    m, stats = step(m, *args0, cam, poses[0])
    jax.block_until_ready(m)

    m = create_sharded_map(cfg, mesh)
    t0 = time.perf_counter()
    for fr, pose in zip(frames, poses):
        m, stats = step(m, *[replicate(a) for a in fr], cam, pose)
    jax.block_until_ready(m)
    dt = time.perf_counter() - t0
    assert int(stats["alloc_failures"]) == 0
    return len(frames) / dt


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, default=0,
                   help="virtual CPU devices per process (0 = native)")
    p.add_argument("--spawn", type=int, default=0,
                   help="spawn N local processes (multi-host demo)")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--coordinator", default="localhost:9921")
    # map scale (defaults = the round-4 small map; pass the bench-scale
    # values 0.01/17/19 to measure at the headline operating point)
    p.add_argument("--voxel-size", type=float, default=0.02)
    p.add_argument("--log2-blocks", type=int, default=15)
    p.add_argument("--log2-hash", type=int, default=17)
    p.add_argument("--no-baseline", action="store_true",
                   help="skip the in-process 1-device baseline row")
    args = p.parse_args(argv)

    if args.spawn > 1:
        # one process per card: a JAX process reserves most of every GPU
        # it can see, so each child is shown only its own
        # (CUDA_VISIBLE_DEVICES does nothing to the virtual-CPU children)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = visible.split(",") if visible else [str(i) for i in range(args.spawn)]
        if len(cards) < args.spawn:
            raise ValueError(f"--spawn {args.spawn} but only cards {cards} are visible")
        procs = []
        for pid in range(args.spawn):
            env = dict(os.environ)
            env.update(
                RA_SLAM_COORDINATOR=args.coordinator,
                RA_SLAM_NUM_PROCESSES=str(args.spawn),
                RA_SLAM_PROCESS_ID=str(pid),
                CUDA_VISIBLE_DEVICES=cards[pid],
            )
            cmd = [sys.executable, "-m", "ra_slam_tpu.pipeline.bench_scaling",
                   "--devices", str(args.devices), "--frames", str(args.frames),
                   "--voxel-size", str(args.voxel_size),
                   "--log2-blocks", str(args.log2_blocks),
                   "--log2-hash", str(args.log2_hash), "--no-baseline"]
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE, text=True,
            ))
        outs = [q.communicate()[0] for q in procs]
        rcs = [q.returncode for q in procs]
        assert all(r == 0 for r in rcs), f"worker exit codes {rcs}"
        line = next(
            ln for ln in outs[0].splitlines() if ln.startswith("{")
        )
        print(line)
        return {"spawned": args.spawn, **json.loads(line)}

    if args.devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.devices:
        jax.config.update("jax_platforms", "cpu")

    from ra_slam_tpu.parallel.distributed import (
        global_mesh,
        initialize_distributed,
        process_info,
        replicate_global,
    )

    initialize_distributed()

    import jax.numpy as jnp

    from ra_slam_tpu.core.config import TsdfConfig
    from ra_slam_tpu.core.se3 import SE3
    from ra_slam_tpu.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    spec = SyntheticCameraSpec(
        fx=320.0, fy=320.0, cx=319.5, cy=239.5, width=640, height=480
    )
    ds = SyntheticBoxDataset(
        num_frames=args.frames, cam=spec,
        half_extents=(3.0, 2.0, 3.0), radius=1.0,
    )
    cfg = TsdfConfig(
        voxel_size=args.voxel_size, truncation=6 * args.voxel_size,
        max_depth=6.0,
        log2_num_blocks=args.log2_blocks, log2_hash_size=args.log2_hash,
        max_visible_blocks=1 << 13, max_new_blocks=1 << 14,
        width=640, height=480,
    )
    cam = ds.camera
    raw = [ds.frame(i) for i in range(args.frames)]
    frames = [
        (jnp.asarray(f.rgb, jnp.float32), jnp.asarray(f.depth),
         jnp.asarray(f.ht), jnp.asarray(f.lt))
        for f in raw
    ]
    poses = [SE3.from_matrix(jnp.asarray(f.cam_T_world)) for f in raw]

    mesh = global_mesh()
    multi = jax.process_count() > 1
    repl = (
        functools.partial(replicate_global, mesh) if multi else (lambda x: x)
    )
    fps_n = _bench_mesh(mesh, cfg, frames, cam, poses, repl)

    out = {
        "metric": "sharded_fused_frames_per_sec",
        "value": round(fps_n, 2),
        "n_devices": len(jax.devices()),
        **process_info(),
    }
    if not multi and len(jax.devices()) > 1 and not args.no_baseline:
        mesh1 = global_mesh(devices=jax.devices()[:1])
        fps_1 = _bench_mesh(mesh1, cfg, frames, cam, poses, lambda x: x)
        out["fps_1dev"] = round(fps_1, 2)
        out["scaling_efficiency"] = round(
            fps_n / (len(jax.devices()) * fps_1), 3
        )
    if jax.process_index() == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    run()
