"""Config dataclasses from YAML-loaded dicts."""

from __future__ import annotations

import dataclasses
import typing


def dataclass_from_dict(cls, d: dict):
    """Build a (possibly nested) config dataclass from a flat YAML dict.

    Keys that name no field are ignored. Nested dicts become nested
    dataclasses, and numeric strings are coerced to the field's type:
    PyYAML parses ``1.0e9`` (exponent without a sign) as a *string*, a
    silent trap for hand-written configs."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints.get(f.name)
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = dataclass_from_dict(t, v)
        elif t in (float, int) and isinstance(v, str):
            v = t(float(v))
        kwargs[f.name] = v
    return cls(**kwargs)
