"""The evaluation suite (PyTorch port of `wam_tpu.evalsuite`): the
`Eval2DWAM` and `Eval1DWAM` faithfulness metrics and the baseline methods'
evaluators `EvalImageBaselines` and `EvalAudioBaselines`, on the fan engine
(`evalsuite.fan`: one counted result fetch per metric call), the baseline
methods (`evalsuite.baselines`, `evalsuite.lrp`), the metric machinery and
the coefficient packing."""

from wam_tpu_torch.evalsuite.baselines import (
    gradcam,
    gradcam_pp,
    integrated_gradients,
    layercam,
    saliency,
    smoothgrad_pixel,
)
from wam_tpu_torch.evalsuite.eval1d import Eval1DWAM
from wam_tpu_torch.evalsuite.eval2d import Eval2DWAM, imagenet_denormalize, imagenet_preprocess
from wam_tpu_torch.evalsuite.eval_baselines import (
    AUDIO_METHODS,
    IMAGE_METHODS,
    EvalAudioBaselines,
    EvalImageBaselines,
)
from wam_tpu_torch.evalsuite.fan import (
    FanPlan,
    device_fetch,
    fan_runner,
    fetch_count,
    fetch_scope,
    plan_fan,
    reset_fetch_count,
    run_fan,
)
from wam_tpu_torch.evalsuite.metrics import (
    compute_auc,
    generate_masks,
    minmax_normalize,
    softmax_probs,
    spearman,
)
from wam_tpu_torch.evalsuite.packing import (
    array_to_coeffs1d,
    array_to_coeffs2d,
    coeffs_to_array1d,
    coeffs_to_array2d,
    packed2d_shape,
)

__all__ = [
    "Eval1DWAM",
    "Eval2DWAM",
    "FanPlan",
    "plan_fan",
    "fan_runner",
    "run_fan",
    "device_fetch",
    "fetch_count",
    "fetch_scope",
    "reset_fetch_count",
    "EvalImageBaselines",
    "EvalAudioBaselines",
    "IMAGE_METHODS",
    "AUDIO_METHODS",
    "saliency",
    "integrated_gradients",
    "smoothgrad_pixel",
    "gradcam",
    "gradcam_pp",
    "layercam",
    "compute_auc",
    "generate_masks",
    "minmax_normalize",
    "softmax_probs",
    "spearman",
    "coeffs_to_array1d",
    "array_to_coeffs1d",
    "coeffs_to_array2d",
    "array_to_coeffs2d",
    "packed2d_shape",
    "imagenet_preprocess",
    "imagenet_denormalize",
]
