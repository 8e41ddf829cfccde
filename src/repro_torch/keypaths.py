"""Trees of tensors walked in the reference's order, with their key paths.

``jax.tree.leaves`` visits a dict's keys sorted; ``torch.utils._pytree``
keeps their insertion order.  The optimiser's global norm adds its leaves'
squared sums in that order, and the checkpoint names each leaf by its
path, so both walk a tree here as JAX does: dict keys sorted, lists and
tuples in order, ``None`` holding no leaf.  A path is the tuple of dict
keys and sequence indices from the root; :func:`key` joins it with ``/``
(``params/groups/0/0/mixer/wq``), as the reference's checkpoint does.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_path(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += leaves_with_path(sub, prefix + (i,))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    """The leaves in JAX's flattening order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable[[Path, Any], Any], tree: Any,
                  prefix: Path = ()) -> Any:
    """The tree of ``fn(path, leaf)``, in the given tree's structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def key(path: Path) -> str:
    """``"/".join`` of the path's keys and indices."""
    return "/".join(str(p) for p in path)
