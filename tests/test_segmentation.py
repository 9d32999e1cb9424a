"""Segmentation model + inference engine tests."""

import os

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from ra_slam_tpu.models import (
    InferenceEngine,
    init_unet,
    load_params,
    make_train_step,
    save_params,
    seg_probs,
)
from ra_slam_tpu.models.segmentation import unet_widths

DEMO = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "ra_slam_tpu", "models", "demo_seg.npz",
)

# The demo net's ht/lt on a fixed 48x64 uint8 frame (numpy seed 0,
# zero-padded to 64x64), computed once with the flax model the weights
# were trained with, before it was rewritten in plain JAX.
GOLDEN_HT_MEAN = 0.05152713879942894
GOLDEN_LT_MEAN = 0.948472797870636
GOLDEN_HT = {
    (0, 0): 0.186774343252182,
    (5, 17): 0.12540718913078308,
    (23, 40): 0.06634944677352905,
    (47, 63): 0.19651636481285095,
    (30, 3): 0.0390663705766201,
}


def _golden_frame():
    return np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)


def test_fake_mode_matches_reference_semantics():
    eng = InferenceEngine(None, width=64, height=48)
    ht, lt = eng.infer_one(np.zeros((48, 64, 3), np.uint8))
    assert ht.shape == (48, 64) and lt.shape == (48, 64)
    np.testing.assert_array_equal(ht, 1.0)
    np.testing.assert_array_equal(lt, 1.0)


def test_demo_weights_reproduce_golden_outputs():
    """Eager op-by-op forward == the flax model's eager forward (same
    ops in the same order), so the golden values hold tightly."""
    params = load_params(DEMO)
    assert unet_widths(params) == (16, 32, 64)
    x = jnp.asarray(_golden_frame(), jnp.float32) / 255.0
    x = jnp.pad(x, ((0, 16), (0, 0), (0, 0)))[None]
    ht, lt = seg_probs(params, x)
    ht, lt = np.asarray(ht[0, :48]), np.asarray(lt[0, :48])
    assert abs(float(ht.mean()) - GOLDEN_HT_MEAN) < 1e-5
    assert abs(float(lt.mean()) - GOLDEN_LT_MEAN) < 1e-5
    for (r, c), v in GOLDEN_HT.items():
        assert abs(float(ht[r, c]) - v) < 1e-4, (r, c, float(ht[r, c]), v)


def test_engine_reads_widths_from_checkpoint():
    """The CLI path: a checkpoint path alone builds the 3-level demo net
    (the default widths are 4-level), jitted; bf16 compute under jit
    rounds differently from the eager golden run."""
    eng = InferenceEngine(DEMO, width=64, height=48)
    assert eng.widths == (16, 32, 64)
    ht, lt = eng.infer_one(_golden_frame())
    assert ht.shape == (48, 64)
    np.testing.assert_allclose(ht + lt, 1.0, atol=1e-5)
    for (r, c), v in GOLDEN_HT.items():
        assert abs(float(ht[r, c]) - v) < 5e-3, (r, c, float(ht[r, c]), v)


def test_npz_round_trip(tmp_path):
    params = init_unet(jax.random.PRNGKey(3), widths=(8, 16))
    path = str(tmp_path / "seg.npz")
    save_params(path, params)
    back = load_params(path)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert unet_widths(back) == (8, 16)


@pytest.mark.slow
def test_random_engine_outputs_probabilities(tmp_path):
    # two-level UNet: the 3-level variant only adds XLA compile time
    eng = InferenceEngine("__random__", width=64, height=48, widths=(8, 16))
    rgb = (np.random.default_rng(0).uniform(0, 255, (48, 64, 3))).astype(np.uint8)
    ht, lt = eng.infer_one(rgb)
    assert ht.shape == (48, 64)
    np.testing.assert_allclose(ht + lt, 1.0, atol=1e-3)  # softmax pair
    assert (ht >= 0).all() and (ht <= 1).all()

    # save / load round trip
    path = str(tmp_path / "seg.npz")
    eng.save(path)
    eng2 = InferenceEngine(path, width=64, height=48)
    ht2, _ = eng2.infer_one(rgb)
    np.testing.assert_allclose(ht, ht2, atol=1e-5)


@pytest.mark.slow  # fast tier keeps the main seg forward/training tests
def test_non_multiple_of_32_input():
    eng = InferenceEngine("__random__", width=50, height=35, widths=(8, 16))
    ht, lt = eng.infer_one(np.zeros((35, 50, 3), np.uint8))
    assert ht.shape == (35, 50) and lt.shape == (35, 50)


def test_training_step_reduces_loss():
    import optax

    x = jnp.stack(
        [
            jnp.concatenate(
                [jnp.ones((32, 16, 3)), jnp.zeros((32, 16, 3))], axis=1
            )
        ]
    )  # left half bright -> class 0, right half dark -> class 1
    y = jnp.concatenate(
        [jnp.zeros((1, 32, 16), jnp.int32), jnp.ones((1, 32, 16), jnp.int32)],
        axis=2,
    )
    params = init_unet(jax.random.PRNGKey(0), widths=(8, 16))
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    step = make_train_step(opt)
    losses = []
    for _ in range(12):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses
