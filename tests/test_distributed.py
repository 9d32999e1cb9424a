"""Multi-process (multi-host style) wiring: 2 processes x 4 CPU devices over
gloo, sharded fusion on the global mesh — the reference has nothing to
mirror here (single GPU, SURVEY.md §5.8); this proves the
`jax.distributed.initialize` path end to end without pod hardware."""

import os
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from ra_slam_tpu.parallel.distributed import (
    initialize_distributed, global_mesh, replicate_global, process_info)
initialize_distributed("localhost:9931", nproc, pid)
info = process_info()
assert info["global_devices"] == 8, info
assert info["local_devices"] == 4, info

import jax.numpy as jnp
import numpy as np
from ra_slam_tpu.core.camera import PinholeCamera
from ra_slam_tpu.core.config import TsdfConfig
from ra_slam_tpu.core.se3 import SE3
from ra_slam_tpu.parallel.sharded_map import (
    create_sharded_map, make_sharded_integrate_step)

cfg = TsdfConfig(voxel_size=0.05, truncation=0.3, max_depth=6.0,
                 log2_num_blocks=12, log2_hash_size=15,
                 max_visible_blocks=2048, width=160, height=120)
H, W = 120, 160
cam = PinholeCamera(fx=jnp.float32(80.0), fy=jnp.float32(80.0),
                    cx=jnp.float32(79.5), cy=jnp.float32(59.5),
                    width=W, height=H)
mesh = global_mesh()
m = create_sharded_map(cfg, mesh)
step = make_sharded_integrate_step(mesh, cfg)
vs, us = np.mgrid[0:H, 0:W]
depth = replicate_global(mesh, (2.0 + 0.2 * np.sin(us / 17.0)).astype(np.float32))
rgb = replicate_global(mesh, np.full((H, W, 3), 128.0, np.float32))
ht = replicate_global(mesh, np.full((H, W), 0.9, np.float32))
lt = replicate_global(mesh, np.full((H, W), 0.1, np.float32))
for _ in range(2):
    m, stats = step(m, rgb, depth, ht, lt, cam, SE3.identity())
jax.block_until_ready(m.tsdf)
assert int(stats["alloc_failures"]) == 0
n_active = int(stats["num_active"])
assert n_active > 0
print(f"pid {pid} OK n_active={n_active}", flush=True)
"""


@pytest.mark.slow
def test_two_process_sharded_fusion():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(pid), "2"],
            env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for q in procs:
        out, _ = q.communicate(timeout=420)
        outs.append(out)
    for pid, (q, out) in enumerate(zip(procs, outs)):
        assert q.returncode == 0, f"pid {pid} failed:\n{out}"
        assert f"pid {pid} OK" in out
    # both processes computed the same global block count
    n0 = outs[0].split("n_active=")[1].split()[0]
    n1 = outs[1].split("n_active=")[1].split()[0]
    assert n0 == n1
