"""Lightweight message base for config schemas.

The reference encodes its Python⇄C++ contract as protobuf (m4-preprocessed
.proto under /root/reference/proto/). In this TPU-native rebuild both sides
of the contract are Python, so configs are plain dataclasses with the same
field names and defaults, serializable to/from JSON for checkpointing and
`dump_config` tooling. ``real`` is float (float32 numerics; see
/root/reference/proto/CMakeLists.txt:15-16 for the reference's WITH_DOUBLE
switch, which we drop — TPUs want f32/bf16).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T", bound="Message")


@dataclasses.dataclass
class Message:
    """Base class: dataclass config message with dict/JSON round-trip."""

    def to_dict(self, keep_defaults: bool = False) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        defaults = _defaults_of(type(self))
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not keep_defaults and _eq_default(v, defaults.get(f.name, _MISSING)):
                continue
            out[f.name] = _encode(v, keep_defaults)
        return out

    @classmethod
    def from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
        hints = get_type_hints(cls)
        kwargs: Dict[str, Any] = {}
        known = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k not in known:
                raise KeyError(f"{cls.__name__}: unknown field {k!r}")
            kwargs[k] = _decode(v, hints[k])
        return cls(**kwargs)

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls: Type[T], s: str) -> T:
        return cls.from_dict(json.loads(s))

    def clone(self: T) -> T:
        return type(self).from_dict(self.to_dict(keep_defaults=True))


class _Missing:
    pass


_MISSING = _Missing()
_DEFAULTS_CACHE: Dict[type, Dict[str, Any]] = {}


def _defaults_of(cls: type) -> Dict[str, Any]:
    cached = _DEFAULTS_CACHE.get(cls)
    if cached is None:
        cached = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                cached[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                cached[f.name] = f.default_factory()  # type: ignore[misc]
        _DEFAULTS_CACHE[cls] = cached
    return cached


def _eq_default(v: Any, default: Any) -> bool:
    if default is _MISSING:
        return False
    if isinstance(v, Message) or isinstance(default, Message):
        return isinstance(v, Message) and isinstance(default, Message) and v.to_dict() == default.to_dict()
    return v == default


def _encode(v: Any, keep_defaults: bool) -> Any:
    if isinstance(v, Message):
        return v.to_dict(keep_defaults)
    if isinstance(v, list):
        return [_encode(x, keep_defaults) for x in v]
    return v


def _decode(v: Any, hint: Any) -> Any:
    origin = get_origin(hint)
    if origin in (list, List):
        (elem,) = get_args(hint)
        return [_decode(x, elem) for x in v]
    if isinstance(hint, type) and issubclass(hint, Message):
        if v is None:
            return None
        return hint.from_dict(v)
    # Optional[Message]
    args = get_args(hint)
    for a in args:
        if isinstance(a, type) and issubclass(a, Message) and isinstance(v, dict):
            return a.from_dict(v)
    return v
