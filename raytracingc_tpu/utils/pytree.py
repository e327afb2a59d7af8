"""Frozen dataclasses registered as JAX pytrees.

``@pytree_node`` turns a class body of annotated fields into a frozen
dataclass whose fields are pytree children, except those declared with
:func:`static_field`, which become treedef metadata (hashable, static under
``jit``). Every node gets ``replace(**changes)``, as ``dataclasses.replace``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax


def static_field(**kwargs: Any) -> Any:
    """A dataclass field kept in the treedef instead of the leaves."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **changes: Any):
    return dataclasses.replace(self, **changes)


def pytree_node(cls: type) -> type:
    """Make ``cls`` a frozen dataclass and register it as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = _replace
    return cls
