"""ra_slam_tpu — semantic SLAM + dense reconstruction in JAX.

A from-scratch JAX/XLA re-design of the capabilities of RA-SLAM
(uiuc-iml/RA-SLAM, the perception system of an autonomous disinfection
robot): ORB-feature visual tracking, local/global bundle adjustment,
pose-graph optimization with loop closure, and voxel-hashed semantic TSDF
fusion with raycast rendering and marching-cubes mesh extraction.

Unlike the reference (single-GPU CUDA + external OpenVSLAM/g2o/libtorch),
everything here is first-party JAX:

  - the dense map is a fixed-capacity voxel-block pool + open-addressed
    spatial hash living in device memory, updated with batched, conflict-free
    functional ops (no device-side locks or atomics);
  - the sparse SLAM stack (FAST/ORB, Hamming matching, Gauss-Newton
    tracking, Schur-complement BA, pose graph) is batched JAX;
  - multi-device scaling uses jax.sharding Mesh + shard_map collectives
    (psum-reduced camera systems, block halo exchange), not threads.

Subpackages
-----------
core      geometry (SO3/SE3, cameras), configuration
map       the voxel-block TSDF map and fusion pipeline
features  FAST/ORB detection, descriptor matching, stereo
slam      sparse visual SLAM: tracking, BA, pose graph, loops
models    learned components (semantic segmentation net)
parallel  device meshes, shardings, distributed BA / halo exchange
io        dataset readers (.sens / TUM folders), binary dump formats
eval      ATE, ScanNet-style semantic scoring, mesh I/O
native    C++ .sens decoder + prefetcher (ctypes)
pipeline  system facades mirroring the reference entry points
utils     timing, logging, pose buffer
"""

__version__ = "0.1.0"


def compilation_cache_dir() -> str:
    """Where JAX's persistent compile cache lives: `JAX_COMPILATION_CACHE_DIR`
    when set, else the fixed in-checkout `<repo>/.jax_cache`. The path is
    part of the cache key, so it never depends on a temp name, a PID or
    the time."""
    import os

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
    )


def _enable_compilation_cache() -> None:
    """Turn on JAX's persistent compile cache, so a second process starts
    warm. With `JAX_COMPILATION_CACHE_DIR` set, JAX reads that directory
    itself and nothing is set here."""
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compilation_cache()
