"""Data and checkpoints (PyTorch port of `wam_tpu.data`): the model registry
and checkpoint loading, image preprocessing and loaders, 3D-MNIST, and the
numpy half of the audio features. PIL, matplotlib and h5py are imported by
the functions that need them, never on import."""

from wam_tpu_torch.data.audio import (
    add_0db_noise,
    logmel_np,
    make_weights_for_balanced_classes,
    stft_np,
)
from wam_tpu_torch.data.checkpoints import (
    build_vision_model,
    load_3d_model,
    load_3dvoxel_model,
    load_audio_model,
    load_variables,
    save_variables,
)
from wam_tpu_torch.data.image import (
    get_alpha_cmap,
    load_images,
    load_imagenet_validation,
    preprocess_image,
    show,
)
from wam_tpu_torch.data.mnist3d import batches, load_3d_mnist, load_3dvoxel_mnist

__all__ = [
    "add_0db_noise",
    "logmel_np",
    "stft_np",
    "make_weights_for_balanced_classes",
    "preprocess_image",
    "load_images",
    "load_imagenet_validation",
    "show",
    "get_alpha_cmap",
    "load_3d_mnist",
    "load_3dvoxel_mnist",
    "batches",
    "build_vision_model",
    "load_3d_model",
    "load_3dvoxel_model",
    "load_audio_model",
    "save_variables",
    "load_variables",
]
