"""ORB frontend: FAST detection, descriptors, matching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ra_slam_tpu.core.config import FeatureConfig
from ra_slam_tpu.features import (
    detect_and_describe,
    fast_corners,
    hamming_matrix,
    hamming_matrix_popcount,
    match_descriptors,
    mutual_match,
)
from ra_slam_tpu.features.orb import orientation
from ra_slam_tpu.features.pyramid import build_pyramid, gaussian_blur


def _square_image(H=120, W=160, seed=0):
    """Noisy background with 4 bright squares -> 16 strong corners."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 2, (H, W)).astype(np.float32)
    squares = [(30, 40), (60, 100), (90, 30), (45, 130)]
    for y, x in squares:
        img[y : y + 14, x : x + 14] += 120.0
    corners = [
        (x0 + dx, y0 + dy) for (y0, x0) in squares for dx in (0, 13) for dy in (0, 13)
    ]
    return jnp.asarray(img), corners


def test_fast_finds_square_corners():
    img, corners = _square_image()
    uv, score, valid = jax.jit(lambda im: fast_corners(im, 20.0, 64))(img)
    uv_v = np.asarray(uv)[np.asarray(valid)].astype(int)
    assert len(uv_v) >= 12
    for u, v in uv_v:
        d = min(abs(u - eu) + abs(v - ev) for eu, ev in corners)
        assert d <= 3, f"spurious corner at {(u, v)}"


def test_fast_empty_on_flat_image():
    img = jnp.full((64, 64), 100.0)
    uv, score, valid = fast_corners(img, 10.0, 32)
    assert int(valid.sum()) == 0


def test_fast_two_threshold_fallback():
    """Low-contrast corners (amplitude ~12) are invisible at the ini
    threshold 20 but must be recovered through the min-threshold 7
    fallback (OpenVSLAM ini/min semantics, SURVEY.md §2.8)."""
    img, corners = _square_image()
    img = img * 0.1  # squares now +12 over background
    uv0, _, valid0 = fast_corners(img, 20.0, 64)
    assert int(valid0.sum()) == 0
    uv1, _, valid1 = jax.jit(
        lambda im: fast_corners(im, 20.0, 64, min_threshold=7.0)
    )(img)
    uv_v = np.asarray(uv1)[np.asarray(valid1)].astype(int)
    assert len(uv_v) >= 8
    for u, v in uv_v:
        d = min(abs(u - eu) + abs(v - ev) for eu, ev in corners)
        assert d <= 3


def test_fast_fallback_is_per_cell():
    """A strong corner in one cell must not disable the fallback in a
    weak-texture cell elsewhere, and strong cells keep the high
    threshold (no weak duplicates next to strong corners)."""
    img = np.random.default_rng(1).normal(0, 1, (128, 128)).astype(np.float32)
    img[20:34, 20:34] += 120.0  # strong square, top-left cell
    img[90:104, 90:104] += 12.0  # weak square, bottom-right cell
    uv, _, valid = fast_corners(
        jnp.asarray(img), 20.0, 64, min_threshold=7.0, cell_size=32
    )
    uv_v = np.asarray(uv)[np.asarray(valid)]
    near_weak = np.abs(uv_v - np.array([90.0, 90.0])).max(1) < 20
    near_strong = np.abs(uv_v - np.array([20.0, 20.0])).max(1) < 20
    assert near_weak.any(), "weak-cell corners lost without fallback"
    assert near_strong.any()


def test_fast_spatial_binning_spreads_keypoints():
    """Dense texture in one quadrant must not crowd out a lone corner
    elsewhere when selection is binned."""
    rng = np.random.default_rng(2)
    img = np.zeros((128, 128), np.float32)
    img[:64, :64] = rng.uniform(0, 255, (64, 64))  # super-textured quadrant
    img[96:110, 96:110] = 200.0  # a single square far away
    K = 32
    uv_g, _, val_g = fast_corners(jnp.asarray(img), 20.0, K)
    uv_b, _, val_b = fast_corners(jnp.asarray(img), 20.0, K, cell_size=32)

    def far_hits(uv, valid):
        pts = np.asarray(uv)[np.asarray(valid)]
        return (pts.min(1) > 90).sum() if len(pts) else 0

    assert far_hits(uv_b, val_b) >= 2, "binning lost the isolated corner"
    # binned selection covers at least as many distinct cells
    def cells(uv, valid):
        pts = (np.asarray(uv)[np.asarray(valid)] // 32).astype(int)
        return {tuple(p) for p in pts}

    assert len(cells(uv_b, val_b)) >= len(cells(uv_g, val_g))


def test_orientation_points_to_bright_side():
    img = np.zeros((64, 64), np.float32)
    img[:, 40:] = 200.0  # bright on +x side
    ang = orientation(jnp.asarray(img), jnp.asarray([[32.0, 32.0]]))
    assert abs(float(ang[0])) < 0.2  # centroid along +x -> angle ~ 0


def test_pyramid_shapes_static():
    img = jnp.zeros((120, 160))
    lv = build_pyramid(img, 4, 1.2)
    assert [l.shape for l in lv] == [(120, 160), (100, 133), (83, 111), (69, 93)]


def test_gaussian_blur_preserves_mean():
    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.uniform(0, 255, (64, 64)).astype(np.float32))
    out = gaussian_blur(img)
    assert abs(float(out.mean()) - float(img.mean())) < 1.0


def test_hamming_matmul_equals_popcount():
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.integers(0, 2**32, (40, 8), dtype=np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, (30, 8), dtype=np.uint32))
    np.testing.assert_array_equal(
        np.asarray(hamming_matrix(a, b)), np.asarray(hamming_matrix_popcount(a, b))
    )


@pytest.mark.parametrize("ka,kb", [(1, 1), (130, 300), (257, 1000)])
def test_hamming_matrix_exact_at_any_size(ka, kb):
    """The bf16 ±1 matmul is exact against XOR + popcount, including
    all-ones / all-zeros words and sizes off any tile multiple."""
    rng = np.random.default_rng(ka)
    a = rng.integers(0, 2**32, (ka, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (kb, 8), dtype=np.uint32)
    a[0], b[-1] = 0xFFFFFFFF, 0
    d = jax.jit(hamming_matrix)(jnp.asarray(a), jnp.asarray(b))
    assert d.shape == (ka, kb) and d.dtype == jnp.float32
    np.testing.assert_array_equal(
        np.asarray(d), np.asarray(hamming_matrix_popcount(jnp.asarray(a), jnp.asarray(b)))
    )
    assert float(d[0, kb - 1]) == 256.0


def test_hamming_matrix_identity_diagonal_is_zero():
    a = jnp.asarray(np.random.default_rng(1).integers(0, 2**32, (64, 8), dtype=np.uint32))
    d = np.asarray(jax.jit(hamming_matrix)(a, a))
    assert (np.diag(d) == 0).all()
    assert (d >= 0).all() and (d <= 256).all()
    np.testing.assert_array_equal(d, d.T)


def test_match_shifted_image():
    img, _ = _square_image()
    img2 = jnp.roll(img, (3, 5), axis=(0, 1))
    cfg = FeatureConfig(max_num_keypoints=300, num_levels=4)
    fn = jax.jit(lambda im: detect_and_describe(im, cfg))
    kp1, kp2 = fn(img), fn(img2)
    m = mutual_match(kp1.desc, kp1.valid, kp2.desc, kp2.valid)
    mv = np.asarray(m.valid)
    assert mv.sum() >= 20
    du = np.asarray(kp2.uv)[np.asarray(m.idx)] - np.asarray(kp1.uv)
    good = mv & (np.abs(du[:, 0] - 5) < 2.5) & (np.abs(du[:, 1] - 3) < 2.5)
    # nearly all mutual matches must be consistent with the true shift
    assert good.sum() >= 0.9 * mv.sum()


def test_match_respects_validity():
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.integers(0, 2**32, (10, 8), dtype=np.uint32))
    valid_a = jnp.ones(10, bool)
    m = match_descriptors(a, valid_a, a, jnp.zeros(10, bool))
    assert int(m.valid.sum()) == 0  # nothing valid to match against
