from ra_slam_tpu.models.segmentation import (
    InferenceEngine,
    init_unet,
    load_params,
    make_train_step,
    save_params,
    seg_probs,
    unet_apply,
)

__all__ = [
    "InferenceEngine",
    "init_unet",
    "load_params",
    "make_train_step",
    "save_params",
    "seg_probs",
    "unet_apply",
]
