"""Wavelet filters and the differentiable 1D, 2D and 3D transforms (PyTorch
port of `wam_tpu.wavelets`): the boundary-mode transforms
(`wavelets.transform`, with the CUDA kernels K1-K3 behind the 2D form), the
periodized orthogonal transforms (`wavelets.periodized`) and the
channel-last 2D transforms (`wavelets.nhwc`)."""

from wam_tpu_torch.wavelets.filters import Wavelet, build_wavelet, qmf
from wam_tpu_torch.wavelets.nhwc import dwt2_nhwc, idwt2_nhwc, wavedec2_nhwc, waverec2_nhwc
from wam_tpu_torch.wavelets.periodized import (
    dwt2_per,
    dwt3_per,
    dwt_per,
    idwt2_per,
    idwt3_per,
    idwt_per,
    wavedec2_per,
    wavedec3_per,
    wavedec_per,
    waverec2_per,
    waverec3_per,
    waverec_per,
)
from wam_tpu_torch.wavelets.transform import (
    DETAIL3D_KEYS,
    Detail2D,
    dwt,
    dwt2,
    dwt3,
    dwt_max_level,
    get_dwt2_impl,
    get_synth2_impl,
    idwt,
    idwt2,
    idwt3,
    resolved_synth2_impl,
    set_dwt2_impl,
    set_synth2_impl,
    wavedec,
    wavedec2,
    wavedec3,
    waverec,
    waverec2,
    waverec3,
)

# the reference's `wam_tpu.wavelets.__all__`. The NHWC transforms are importable from here
# too, but stay out of `__all__`, as the reference lists them in
# `wavelets.nhwc` only.
__all__ = [
    "Wavelet",
    "set_dwt2_impl",
    "get_dwt2_impl",
    "set_synth2_impl",
    "get_synth2_impl",
    "resolved_synth2_impl",
    "build_wavelet",
    "qmf",
    "Detail2D",
    "DETAIL3D_KEYS",
    "dwt",
    "idwt",
    "dwt2",
    "idwt2",
    "dwt3",
    "idwt3",
    "wavedec",
    "waverec",
    "wavedec2",
    "waverec2",
    "wavedec3",
    "waverec3",
    "dwt_max_level",
    "dwt_per",
    "idwt_per",
    "dwt2_per",
    "idwt2_per",
    "dwt3_per",
    "idwt3_per",
    "wavedec_per",
    "waverec_per",
    "wavedec2_per",
    "waverec2_per",
    "wavedec3_per",
    "waverec3_per",
]
