"""String-keyed registries (factories).

Port of ``enhax/registry.py``: a dict-like registry with decorator
registration, name-convention fuzzing (kebab/snake case) and
``build(name, **kwargs)`` instantiation. ``ModelRegistry`` adds the 2-level
``{arch: {name: entry}}`` namespace. Entries need not be classes: model
entries are factory callables returning ``Model`` specs.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Iterable


def normalize_name(name: str) -> str:
    """Canonical key: lowercase snake_case (kebab-case folded)."""
    return name.strip().replace("-", "_").lower()


def name_variants(name: str) -> list[str]:
    """Lookup candidates for a user-supplied name (kebab/snake tolerant)."""
    n = normalize_name(name)
    return [n, n.replace("_", "-"), n.replace("_", "")]


class Registry:
    """A string-keyed factory registry.

    Usage::

        LOSSES = Registry("losses")

        @LOSSES.register(name="charbonnier_loss")
        def charbonnier_loss(...): ...

        fn = LOSSES.get("charbonnier-loss")
        obj = LOSSES.build("charbonnier_loss", eps=1e-3)
    """

    def __init__(self, name: str):
        self.name = name
        self._entries: dict[str, Any] = {}
        self._aliases: dict[str, str] = {}

    # -- registration ------------------------------------------------------

    def register(
        self,
        name: str | None = None,
        obj: Any = None,
        aliases: Iterable[str] = (),
        replace: bool = False,
    ):
        """Register ``obj`` under ``name``. Usable as a decorator."""
        if obj is None:
            def decorator(o):
                self.register(name=name, obj=o, aliases=aliases, replace=replace)
                return o
            return decorator

        key = normalize_name(name or getattr(obj, "__name__", str(obj)))
        if key in self._entries and not replace:
            raise KeyError(f"{self.name}: {key!r} already registered")
        self._entries[key] = obj
        for a in aliases:
            self._aliases[normalize_name(a)] = key
        return obj

    # -- lookup ------------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        try:
            self.get(name)
            return True
        except KeyError:
            return False

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self):
        return iter(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()

    def get(self, name: str) -> Any:
        n = normalize_name(name)
        if n in self._entries:
            return self._entries[n]
        if n in self._aliases:
            return self._entries[self._aliases[n]]
        raise KeyError(
            f"{self.name}: no entry named {name!r}. "
            f"Known: {sorted(self._entries)[:20]}..."
        )

    def canonical_name(self, name: str) -> str:
        """Resolve a name or alias to its canonical registered key
        (e.g. ``peak_signal_noise_ratio`` -> ``psnr``)."""
        n = normalize_name(name)
        if n in self._entries:
            return n
        if n in self._aliases:
            return self._aliases[n]
        raise KeyError(f"{self.name}: no entry named {name!r}")

    # -- construction ------------------------------------------------------

    def build(self, name: str | None = None, config: dict | None = None, **kwargs) -> Any:
        """Instantiate/call the registered entry.

        Mirrors the reference's ``Factory.build`` contract
        (core/factory.py:58-134): ``config`` is a dict of ctor kwargs; an
        explicit ``name`` key inside ``config`` is honored; extra ``kwargs``
        override config values.
        """
        cfg = dict(config or {})
        name = name or cfg.pop("name", None)
        if name is None:
            raise ValueError(f"{self.name}.build: no name given")
        cfg.update(kwargs)
        entry = self.get(name)
        if inspect.isclass(entry) or callable(entry):
            cfg = self._filter_kwargs(entry, cfg)
            return entry(**cfg)
        return entry

    def build_instances(self, configs: list | None) -> list:
        """Build many entries from a list of {name: ..., **kwargs} dicts."""
        if not configs:
            return []
        out = []
        for c in configs:
            if isinstance(c, str):
                out.append(self.build(c))
            elif isinstance(c, dict):
                out.append(self.build(config=dict(c)))
            else:
                out.append(c)
        return out

    @staticmethod
    def _filter_kwargs(fn: Callable, cfg: dict) -> dict:
        """Drop kwargs the callable does not accept (unless it has **kwargs)."""
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            return cfg
        if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
            return cfg
        accepted = set(sig.parameters)
        return {k: v for k, v in cfg.items() if k in accepted}


class ModelRegistry(Registry):
    """Registry with a secondary ``{arch: [names]}`` index.

    Mirrors the reference's ``ModelFactory`` 2-level namespace
    (core/factory.py:233-330) used by the interactive CLI to list models
    per architecture per task.
    """

    def __init__(self, name: str):
        super().__init__(name)
        self._arch_index: dict[str, list[str]] = {}
        self._meta: dict[str, dict] = {}

    def register(
        self,
        name: str | None = None,
        obj: Any = None,
        arch: str | None = None,
        aliases: Iterable[str] = (),
        replace: bool = False,
        **meta,
    ):
        if obj is None:
            def decorator(o):
                self.register(name=name, obj=o, arch=arch, aliases=aliases,
                              replace=replace, **meta)
                return o
            return decorator

        super().register(name=name, obj=obj, aliases=aliases, replace=replace)
        key = normalize_name(name or obj.__name__)
        a = normalize_name(arch or getattr(obj, "arch", None) or key)
        self._arch_index.setdefault(a, [])
        if key not in self._arch_index[a]:
            self._arch_index[a].append(key)
        self._meta[key] = dict(meta)
        return obj

    @property
    def archs(self) -> list[str]:
        return sorted(self._arch_index)

    def models_for_arch(self, arch: str) -> list[str]:
        return list(self._arch_index.get(normalize_name(arch), []))

    def meta(self, name: str) -> dict:
        return self._meta.get(normalize_name(name), {})

    def models_for_task(self, task) -> list[str]:
        out = []
        for key, meta in self._meta.items():
            tasks = meta.get("tasks") or getattr(self._entries.get(key), "tasks", ())
            if task in tuple(tasks):
                out.append(key)
        return sorted(out)
