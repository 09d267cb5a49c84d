"""Nested containers of tensors — the port's stand-in for ``jax.tree``.

A tree is a dict, list or tuple whose leaves are anything else (tensors,
NumPy arrays, numbers).  Dict keys are visited in sorted order and
paths print as ``jax.tree_util.keystr`` prints them (``['blocks'][0]``),
so a flattened tree lines up key for key with the JAX package's.
"""
from __future__ import annotations


def items(tree, path=()):
    """(path, leaf) pairs, dict keys in sorted order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from items(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from items(sub, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure); the structure is kept."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """A tree of ``tree``'s structure holding ``new_leaves`` in the
    order :func:`leaves` lists them."""
    it = iter(new_leaves)
    order = [path for path, _ in items(tree)]
    placed = dict(zip(order, it))
    return map_with_path(lambda path, _: placed[path], tree)


def map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{key!r}]" for key in path)
