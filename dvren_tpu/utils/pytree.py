"""Small pytree helpers."""

from __future__ import annotations

import dataclasses
from typing import TypeVar

import jax

_T = TypeVar("_T")


def pytree_dataclass(cls: type[_T] | None = None, *, meta_fields: tuple[str, ...] = ()):
    """Register a dataclass as a JAX pytree.

    Fields named in ``meta_fields`` are static (hashable aux data, part of the
    jit cache key); all other fields are traced leaves.
    """

    def wrap(inner: type[_T]) -> type[_T]:
        if not dataclasses.is_dataclass(inner):
            inner = dataclasses.dataclass(frozen=True)(inner)
        data_fields = tuple(
            f.name for f in dataclasses.fields(inner) if f.name not in meta_fields
        )
        jax.tree_util.register_dataclass(
            inner, data_fields=data_fields, meta_fields=tuple(meta_fields)
        )
        return inner

    if cls is None:
        return wrap
    return wrap(cls)


def device_put_tree(tree):
    """One BATCHED ``jax.device_put`` over a pytree's leaves (one transfer
    for the whole tree instead of a dispatch per leaf), preserving
    aliasing: leaves that are the same host array upload once and share
    one device buffer."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    order: dict[int, int] = {}
    uniq = []
    for leaf in leaves:
        if id(leaf) not in order:
            order[id(leaf)] = len(uniq)
            uniq.append(leaf)
    dev = jax.device_put(uniq)
    return jax.tree_util.tree_unflatten(
        treedef, [dev[order[id(leaf)]] for leaf in leaves])
