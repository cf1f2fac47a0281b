"""Maps over nested dicts/lists/tuples of tensors (the parameter trees)."""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    the trees in ``rest``, which share its structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves: Sequence):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves``' order) in
    place of its own."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_stack(trees: Sequence) -> Any:
    """Stack the matching leaves of several same-structure trees on a new
    leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor of ``tree`` to ``dtype``."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def to_device(tree, device):
    """Move every tensor of ``tree`` to ``device`` (other leaves stay)."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)
