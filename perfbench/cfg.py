"""A configuration file of ``perfbench/configs/`` as attribute access
(``hps.model.hidden_channels``), for the reference and the harness."""

from __future__ import annotations

import json
from pathlib import Path


class Cfg(dict):
    """A dict whose keys read as attributes; nested dicts become Cfg."""

    def __init__(self, data: dict):
        super().__init__({k: Cfg(v) if isinstance(v, dict) else v for k, v in data.items()})

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None


def load(path: str | Path) -> Cfg:
    return Cfg(json.loads(Path(path).read_text()))
