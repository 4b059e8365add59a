"""Configuration files to dataclasses: lists become tuples, and the string
"inf" (JSON has no infinity) becomes float('inf')."""

from __future__ import annotations

import dataclasses


def build(cls, values: dict, **overrides):
    """``cls`` from the JSON ``values`` (every field must be known)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - fields
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = {}
    for k, v in {**values, **overrides}.items():
        if isinstance(v, list):
            v = tuple(v)
        elif v == "inf":
            v = float("inf")
        kw[k] = v
    return cls(**kw)
