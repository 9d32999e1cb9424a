"""Semantic segmentation: high-touch / low-touch probability maps.

The reference runs an externally-trained TorchScript CNN through
libtorch (`/root/reference/segmentation/inference.cc:62-99`): resize the
RGB frame to a /32 multiple, HWC->NCHW float tensor, forward, split the
2-channel output into ht/lt probability maps, resize back; with an
empty model path it degrades to all-ones maps (`inference.cc:50-52`) so
the rest of the pipeline runs without a model.

Equivalent here: a compact NHWC UNet in plain JAX (bfloat16 compute,
float32 params), a jitted `InferenceEngine` facade with identical
resize/fake-mode semantics, `.npz` checkpoints, and an optional optax
training step (the reference ships no trainer; this closes that gap for
users who need to fit the model).

Parameters are a nested dict:

    {"down0".."down{L-2}": block, "mid": block,
     "up0".."up{L-2}": {"conv": conv, "block": block}, "head": conv}
    block = {"conv0": conv, "norm0": norm, "conv1": conv, "norm1": norm}
    conv  = {"w": [kh, kw, cin, cout], "b": [cout]}
    norm  = {"scale": [c], "bias": [c]}

so the widths of a checkpoint are read off its parameter shapes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

COMPUTE_DTYPE = jnp.bfloat16
GN_EPS = 1e-6


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _conv(p: dict, x: jax.Array, dtype=COMPUTE_DTYPE) -> jax.Array:
    """SAME-padded stride-1 NHWC conv; inputs, kernel and bias in `dtype`."""
    y = jax.lax.conv_general_dilated(
        x.astype(dtype),
        p["w"].astype(dtype),
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + p["b"].astype(dtype)


def _group_norm(p: dict, x: jax.Array, groups: int) -> jax.Array:
    """GroupNorm with float32 statistics, output in the input dtype."""
    n, h, w, c = x.shape
    xf = x.astype(jnp.float32)
    xg = xf.reshape(n, h, w, groups, c // groups)
    mu = jnp.mean(xg, axis=(1, 2, 4))  # [n, groups]
    mu2 = jnp.mean(xg * xg, axis=(1, 2, 4))
    var = jnp.maximum(0.0, mu2 - mu * mu)
    per_channel = lambda s: jnp.repeat(s, c // groups, axis=-1)[:, None, None]
    y = (xf - per_channel(mu)) * (
        per_channel(jax.lax.rsqrt(var + GN_EPS)) * p["scale"]
    )
    return (y + p["bias"]).astype(x.dtype)


def _max_pool2(x: jax.Array) -> jax.Array:
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID"
    )


def _block(p: dict, x: jax.Array) -> jax.Array:
    for i in range(2):
        x = _conv(p[f"conv{i}"], x)
        x = _group_norm(p[f"norm{i}"], x, min(8, x.shape[-1]))
        x = jax.nn.relu(x)
    return x


def unet_apply(params: dict, x: jax.Array) -> jax.Array:
    """[N, H, W, 3] float in [0, 1] -> [N, H, W, 2] float32 logits.

    Encoder/decoder with skip connections; H and W must be multiples of
    2^(levels-1)."""
    depth = len([k for k in params if k.startswith("down")])
    x = x.astype(COMPUTE_DTYPE)
    skips = []
    for i in range(depth):
        x = _block(params[f"down{i}"], x)
        skips.append(x)
        x = _max_pool2(x)
    x = _block(params["mid"], x)
    for i, skip in enumerate(reversed(skips)):
        x = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)  # nearest x2
        x = _conv(params[f"up{i}"]["conv"], x)
        x = jnp.concatenate([x, skip], axis=-1)
        x = _block(params[f"up{i}"]["block"], x)
    return _conv(params["head"], x, dtype=jnp.float32)


def unet_widths(params: dict) -> Tuple[int, ...]:
    """Per-level channel widths, read off the parameter shapes."""
    depth = len([k for k in params if k.startswith("down")])
    widths = [params[f"down{i}"]["conv0"]["w"].shape[-1] for i in range(depth)]
    return tuple(widths) + (params["mid"]["conv0"]["w"].shape[-1],)


def init_unet(
    key: jax.Array, widths: Sequence[int] = (32, 64, 128, 256),
    num_classes: int = 2, in_channels: int = 3,
) -> dict:
    """Random float32 params: LeCun-normal kernels, zero biases, unit
    GroupNorm scales."""
    keys = iter(jax.random.split(key, 4 * len(widths) + 1))

    def conv(k, cin, cout):
        w = jax.random.normal(next(keys), (k, k, cin, cout), jnp.float32)
        return {"w": w / np.sqrt(k * k * cin), "b": jnp.zeros((cout,))}

    def norm(c):
        return {"scale": jnp.ones((c,)), "bias": jnp.zeros((c,))}

    def block(cin, cout):
        return {"conv0": conv(3, cin, cout), "norm0": norm(cout),
                "conv1": conv(3, cout, cout), "norm1": norm(cout)}

    params, cin = {}, in_channels
    for i, w in enumerate(widths[:-1]):
        params[f"down{i}"] = block(cin, w)
        cin = w
    params["mid"] = block(cin, widths[-1])
    cin = widths[-1]
    for i, w in enumerate(reversed(widths[:-1])):
        params[f"up{i}"] = {"conv": conv(3, cin, w), "block": block(2 * w, w)}
        cin = w
    params["head"] = conv(1, cin, num_classes)
    return params


# ---------------------------------------------------------------------------
# Checkpoints: one flat `.npz`, keys are "/"-joined dict paths
# ---------------------------------------------------------------------------


def save_params(path: str, params: dict) -> None:
    flat = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v, np.float32)

    walk(params, "")
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_params(path: str) -> dict:
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            d = params
            for k in parents:
                d = d.setdefault(k, {})
            d[leaf] = jnp.asarray(z[key], jnp.float32)
    return params


# ---------------------------------------------------------------------------
# Inference engine
# ---------------------------------------------------------------------------


def _pad_to_multiple(h: int, w: int, m: int = 32) -> Tuple[int, int]:
    """Reference resizes to the nearest /32 multiple
    (`inference.cc:71-76`); we round up."""
    return ((h + m - 1) // m) * m, ((w + m - 1) // m) * m


def seg_probs(params: dict, x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """[N, H, W, 3] in [0, 1] -> (ht, lt) float32 softmax probabilities."""
    prob = jax.nn.softmax(unet_apply(params, x), axis=-1)
    return prob[..., 0], prob[..., 1]


class InferenceEngine:
    """Per-frame ht/lt inference (reference `inference_engine` API).

    `model_path=None` -> fake mode: all-ones maps, letting the full
    pipeline run without a trained model (`inference.cc:50-52`).
    `"__random__"` -> randomly initialised net of the given `widths`;
    otherwise the widths come from the `.npz` checkpoint.
    """

    def __init__(
        self,
        model_path: Optional[str] = None,
        width: int = 640,
        height: int = 480,
        widths: Sequence[int] = (32, 64, 128, 256),
    ):
        self.fake = model_path is None
        self.width = width
        self.height = height
        if self.fake:
            return
        if model_path == "__random__":
            self.params = init_unet(jax.random.PRNGKey(0), widths)
        else:
            self.params = load_params(model_path)
        self.widths = unet_widths(self.params)
        self._forward = jax.jit(seg_probs)

    def infer_one(self, rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[H, W, 3] uint8/float RGB -> (ht, lt) float32 prob maps at the
        engine's configured output size."""
        if self.fake:
            shape = (self.height, self.width)
            return (
                np.ones(shape, np.float32),
                np.ones(shape, np.float32),
            )
        h, w = rgb.shape[:2]
        ph, pw = _pad_to_multiple(h, w)
        x = jnp.asarray(rgb, jnp.float32) / 255.0
        x = jnp.pad(x, ((0, ph - h), (0, pw - w), (0, 0)))
        ht, lt = self._forward(self.params, x[None])
        ht = np.asarray(ht[0, :h, :w], np.float32)
        lt = np.asarray(lt[0, :h, :w], np.float32)
        if (h, w) != (self.height, self.width):
            import cv2

            ht = cv2.resize(ht, (self.width, self.height))
            lt = cv2.resize(lt, (self.width, self.height))
        return ht, lt

    def save(self, path: str) -> None:
        assert not self.fake, "fake engine has no parameters"
        save_params(path, self.params)


def make_train_step(optimizer):
    """Cross-entropy training step (optax) for the segmentation net.

    Labels: [N, H, W] int32 in {0 (high-touch), 1 (low-touch)}, with
    -1 = unlabeled (masked out).
    """
    import optax

    def loss_fn(params, x, y):
        logits = unet_apply(params, x)
        mask = (y >= 0).astype(jnp.float32)
        yc = jnp.maximum(y, 0)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, yc)
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def _bench(argv=None) -> dict:
    """Segmentation inference micro-benchmark — the reference's
    1000-iteration timing harness
    (`/root/reference/examples/segmentation_inference/main.cc:48-60`).

        python -m ra_slam_tpu.models.segmentation --iters 1000
    """
    import argparse
    import json
    import time

    p = argparse.ArgumentParser(description="segmentation latency bench")
    p.add_argument("--model", default=None, help="checkpoint (None = random init)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--iters", type=int, default=1000)
    args = p.parse_args(argv)

    eng = InferenceEngine(
        args.model or "__random__", width=args.width, height=args.height
    )
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (args.height, args.width, 3), dtype=np.uint8)

    ht, lt = eng.infer_one(rgb)  # warmup / compile
    t0 = time.perf_counter()
    for _ in range(args.iters):
        ht, lt = eng.infer_one(rgb)
    dt = (time.perf_counter() - t0) / args.iters
    dev = jax.devices()[0]
    out = {
        "metric": "segmentation_latency_ms",
        "value": dt * 1e3,
        "fps": 1.0 / dt,
        "iters": args.iters,
        "shape": [args.height, args.width],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    _bench()
