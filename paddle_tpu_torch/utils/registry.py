"""Name → factory registries.

TPU-native analog of the reference's ``ClassRegistrar``
(/root/reference/paddle/utils/ClassRegistrar.h): layer types, activations,
evaluators, data providers and optimizers all register themselves by name so
config-driven construction can look them up.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterable, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A simple name→object registry with decorator-style registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, *names: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            for name in names:
                if name in self._entries:
                    raise KeyError(f"duplicate {self.kind} registration: {name!r}")
                self._entries[name] = obj
            return obj

        return deco

    def register_obj(self, name: str, obj: T) -> None:
        if name in self._entries:
            raise KeyError(f"duplicate {self.kind} registration: {name!r}")
        self._entries[name] = obj

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: [{known}]"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> Iterable[str]:
        return sorted(self._entries)
