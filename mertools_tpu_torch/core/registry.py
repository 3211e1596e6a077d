"""Global name→class registry (the port's copy of the part of
``mertools_tpu/core/registry.py`` it uses).

Fusion models and dataset loaders register into namespaced tables, so the
CLIs resolve ``--model`` and ``--dataset`` by name.
"""

from __future__ import annotations

from typing import Any, Callable


class Registry:
    def __init__(self):
        self._tables: dict[str, dict[str, Any]] = {}

    def _table(self, kind: str) -> dict[str, Any]:
        return self._tables.setdefault(kind, {})

    def register(self, kind: str, name: str) -> Callable:
        def deco(obj):
            table = self._table(kind)
            if name in table and table[name] is not obj:
                raise KeyError(f"{kind}:{name} already registered to {table[name]}")
            table[name] = obj
            return obj

        return deco

    def get(self, kind: str, name: str) -> Any:
        table = self._table(kind)
        if name not in table:
            known = ", ".join(sorted(table)) or "<none>"
            raise KeyError(f"unknown {kind} {name!r}; known: {known}")
        return table[name]

    def names(self, kind: str) -> list[str]:
        return sorted(self._table(kind))

    def register_model(self, name):
        return self.register("model", name)

    def register_dataset(self, name):
        return self.register("dataset", name)

    def get_model(self, name):
        return self.get("model", name)

    def get_dataset(self, name):
        return self.get("dataset", name)


registry = Registry()
