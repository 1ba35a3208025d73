"""Where a name in ``BENCHMARK.json`` leads: a file under the benchmark's
directory (``here``, this package by default), found by the name alone.

``configs/<file>``, ``mixes/<traffic>.json``, ``limits/<cell>.json``,
``layers/<family>.py`` (a per-layer metric family), ``kinds/<kind>.py`` (a
traffic kind that `traffic.KINDS` does not hold) and ``reference/<name>.py``
(a configuration's plain reference).  So a later cell joins with new files
and entries alone.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from typing import Dict

HERE = pathlib.Path(__file__).resolve().parent


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: pathlib.Path, name: str):
    """The module of the file ``path``, executed anew, under ``name`` in
    `sys.modules` (dataclasses look their module up there)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def module(here: pathlib.Path, folder: str, name: str):
    """The module ``<here>/<folder>/<name>.py``."""
    path = pathlib.Path(here) / folder / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {folder} module {name!r} ({path})")
    return load_module(path, f"ocpbench_{folder}_{name}".replace("-", "_").replace(".", "_"))
