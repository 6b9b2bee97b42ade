"""YAML-first config system (a copy of seq2seq_vc_tpu/core/config.py:18-67).

The YAML file is the canon, CLI arguments are merged over it, an optional
``additional_config`` overlay is applied last, and the effective config
(plus the package version) is dumped to ``<outdir>/config.yml``, which the
decode and serve entry points read back.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import yaml


def load_config(path: str) -> Dict[str, Any]:
    """Load a YAML config file into a plain dict."""
    with open(path) as f:
        config = yaml.safe_load(f)
    return config or {}


def merge_args(config: Dict[str, Any], args: Any,
               additional_config: Optional[str] = None) -> Dict[str, Any]:
    """``config.update(vars(args))``, then ``config.update(additional_config)``."""
    config = dict(config)
    if args is not None:
        config.update(vars(args))
    if additional_config:
        config.update(load_config(additional_config))
    return config


def dump_config(config: Dict[str, Any], outdir: str, version: str) -> str:
    """Dump the effective config and ``version`` to ``<outdir>/config.yml``."""
    os.makedirs(outdir, exist_ok=True)
    config = dict(config, version=version)
    path = os.path.join(outdir, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(_yaml_safe(config), f, default_flow_style=False)
    return path


def _yaml_safe(obj: Any) -> Any:
    """Coerce values (paths, numpy scalars) into YAML-serialisable types."""
    if isinstance(obj, dict):
        return {k: _yaml_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_yaml_safe(v) for v in obj]
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except (TypeError, ValueError):  # an array of more than one element
            return str(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
