"""Tensor trees and cyclic row padding, shared by the mesh runners of
`parallel.sharded` and `evalsuite.fan`.

A tree is a tensor, or a list, tuple, namedtuple or dict of trees (a step's
result, a coefficient tree, a metric's arguments), or an object with a
``map_blocks`` method (`halo.Sharded`: its blocks are its tensors); anything
else is a leaf that passes through unchanged.
"""

from __future__ import annotations

import torch

__all__ = ["tree_map", "tree_leaves", "tree_zip_map", "cyclic_pad_index"]


def tree_map(fn, tree):
    """``fn`` over every tensor of ``tree``, keeping the structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "map_blocks"):
        return tree.map_blocks(fn)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, in `tree_map` order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_zip_map(fn, trees: list):
    """``fn(*tensors)`` over the positionally matching tensors of trees of
    one structure."""
    it = [iter(tree_leaves(t)) for t in trees]
    return tree_map(lambda _: fn(*(next(i) for i in it)), trees[0])


def cyclic_pad_index(rows: int, multiple: int) -> tuple[torch.Tensor | None, int]:
    """Row indices padding ``rows`` to a multiple of ``multiple`` with
    cyclic copies (0, 1, ..., rows-1, 0, 1, ...), or None when it divides,
    and the padded length."""
    pad = (-rows) % multiple
    if not pad:
        return None, rows
    return torch.arange(rows + pad) % rows, rows + pad
