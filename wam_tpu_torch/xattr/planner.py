"""Patch-aligned wavelet level planning for ViT attribution (PyTorch port of
`wam_tpu.xattr.planner`).

A ViT cuts an (S, S) image into an (S/p, S/p) grid of p x p patches. Dyadic
level j has coefficient cells of side 2**j pixels, so the levels with
2**j >= p are token-granular: each cell covers a whole number of tokens
(224 px, patch 16: a 14 x 14 grid, level-4 cells are one token each).

`plan_patch_levels` picks J = log2(patch), the deepest decomposition whose
finest level is still inside a patch and whose coarsest lands exactly on
the token grid, and rejects what the token map cannot honour: a patch that
is not a power of two, an image not divisible by the patch, or J beyond
`dwt_max_level` for the wavelet. `WaveletAttribution2D(level_plan="patch")`
uses it. `token_grid_map` average-pools any (..., S, S) pixel map onto the
(..., t, t) token grid.
"""

from __future__ import annotations

import dataclasses

import torch

from wam_tpu_torch.wavelets.filters import build_wavelet
from wam_tpu_torch.wavelets.transform import dwt_max_level

__all__ = ["PatchLevelPlan", "plan_patch_levels", "token_grid_map"]


@dataclasses.dataclass(frozen=True)
class PatchLevelPlan:
    """``J`` dyadic levels for ``image_size`` px inputs on a ``patch`` px
    grid of ``tokens`` x ``tokens`` tokens."""

    J: int
    patch: int
    image_size: int
    tokens: int
    wavelet: str = "haar"

    def level_cell_px(self, j: int) -> int:
        """Pixel side of one level-j coefficient cell (1 <= j <= J)."""
        return 2**j

    def token_granular_levels(self) -> tuple[int, ...]:
        """The levels whose cells tile whole tokens: (J,) for J = log2(patch)."""
        return tuple(j for j in range(1, self.J + 1) if 2**j >= self.patch)


def plan_patch_levels(image_size: int, patch: int = 16, wavelet: str = "haar") -> PatchLevelPlan:
    """Plan the dyadic levels of a patch grid; ValueError on a geometry the
    token map cannot honour."""
    if patch < 2 or (patch & (patch - 1)) != 0:
        raise ValueError(f"patch={patch} is not a power of two ≥ 2 — dyadic wavelet "
                         "levels cannot align to it")
    if image_size <= 0 or image_size % patch != 0:
        raise ValueError(f"image_size={image_size} is not divisible by patch={patch} — "
                         "no token grid exists (ViT would reject this input too)")
    J = patch.bit_length() - 1  # log2(patch)
    max_j = dwt_max_level(image_size, len(build_wavelet(wavelet).dec_lo))
    if J > max_j:
        raise ValueError(f"patch={patch} needs J={J} levels but wavelet {wavelet!r} "
                         f"supports at most {max_j} on {image_size}px inputs")
    return PatchLevelPlan(J=J, patch=patch, image_size=image_size, tokens=image_size // patch,
                          wavelet=wavelet)


def token_grid_map(maps: torch.Tensor, tokens: int) -> torch.Tensor:
    """Average-pool (..., S, S) pixel maps onto the (..., tokens, tokens)
    token grid: a reshape and a mean, exact when S is a multiple of
    ``tokens`` (the planner guarantees it)."""
    *lead, h, w = maps.shape
    if h % tokens or w % tokens:
        raise ValueError(f"map of {(h, w)} px does not tile a {tokens}×{tokens} token grid")
    pooled = maps.reshape(*lead, tokens, h // tokens, tokens, w // tokens)
    return pooled.mean(dim=(-3, -1))
