"""Transformer-native and temporal attribution (PyTorch port of
`wam_tpu.xattr`):

- `xattr.attention`: attention rollout and grad x attention relevance from
  the ViT's captured softmax weights (``capture_attn=True``), under the
  evaluators' (x, y) -> (B, H, W) contract;
- `xattr.planner`: patch-aligned level planning (``level_plan="patch"`` in
  `WaveletAttribution2D`) and token-grid pooling;
- `xattr.video` / `xattr.video_eval`: video WAM (space and time with an
  anisotropic level spec) and temporal insertion/deletion through the
  evaluation fan, one fetch a metric call.
"""

from wam_tpu_torch.xattr.attention import (
    attention_gradient,
    attention_rollout,
    attention_weight_grads,
    capture_attention_weights,
    relevance_from_grads,
    rollout_from_weights,
)
from wam_tpu_torch.xattr.planner import PatchLevelPlan, plan_patch_levels, token_grid_map
from wam_tpu_torch.xattr.video import (
    VideoLevels,
    WaveletAttributionVideo,
    frame_importance,
    spacetime_map,
    wavedec_video,
    waverec_video,
)
from wam_tpu_torch.xattr.video_eval import EvalVideoWAM

__all__ = [
    "attention_rollout",
    "attention_gradient",
    "attention_weight_grads",
    "capture_attention_weights",
    "rollout_from_weights",
    "relevance_from_grads",
    "PatchLevelPlan",
    "plan_patch_levels",
    "token_grid_map",
    "VideoLevels",
    "WaveletAttributionVideo",
    "wavedec_video",
    "waverec_video",
    "spacetime_map",
    "frame_importance",
    "EvalVideoWAM",
]
