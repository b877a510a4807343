"""Python-module config loading and the three-tier merge.

Port of ``enhax/utils/config.py``: a config is a Python module whose
module-level values (``model``, ``model_cfg``, ``data_cfg``,
``optimizer_cfg``, ``trainer_cfg``, ...) become a dict; configs are found by
stem under ``config/`` and ``configs/`` directories and merged with the
command line's flags (flags win). ``configs/*.py`` load as they are.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Any


def load_config(path: str | Path) -> dict[str, Any]:
    """Load a ``.py`` config module (its non-dunder, non-callable,
    non-module globals) or a ``.json`` file into a plain dict."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"config not found: {path}")
    if path.suffix == ".py":
        spec = importlib.util.spec_from_file_location(f"_enhax_torch_cfg_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        try:
            spec.loader.exec_module(mod)
        finally:
            sys.modules.pop(spec.name, None)
        return {k: v for k, v in vars(mod).items()
                if not k.startswith("__") and not callable(v)
                and not isinstance(v, type(sys))}
    if path.suffix == ".json":
        return json.loads(path.read_text())
    raise NotImplementedError(f"config {path}: only .py and .json configs are ported "
                              "(YAML comes with ROADMAP item 1.12)")


def parse_config_file(config: str | Path | None,
                      search_dirs: list[str | Path] = ()) -> Path | None:
    """Resolve a config name or stem to a file: an existing path passes
    through; otherwise each dir (and its ``config/`` and ``configs/``
    children) is searched for ``<stem>.py`` / ``.yaml`` / ``.yml`` / ``.json``."""
    if config in (None, "", "none"):
        return None
    p = Path(config)
    if p.is_file():
        return p
    for d in map(Path, search_dirs):
        for base in (d, d / "config", d / "configs"):
            for ext in (".py", ".yaml", ".yml", ".json"):
                c = base / f"{p.stem}{ext}"
                if c.is_file():
                    return c
    raise FileNotFoundError(f"config {config!r} not found in {[str(s) for s in search_dirs]}")


def merge_configs(base: dict, *overrides: dict) -> dict:
    """Deep-merge dicts; later values win; ``None`` override values are
    skipped. Nested dicts are copied, so callers may mutate the result."""
    out = {k: (merge_configs(v) if isinstance(v, dict) else v) for k, v in base.items()}
    for ov in overrides:
        for k, v in (ov or {}).items():
            if v is None:
                continue
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = merge_configs(out[k], v)
            elif isinstance(v, dict):
                out[k] = merge_configs(v)
            else:
                out[k] = v
    return out
