"""Where a configuration's reference files are, by two rules that need no
torch (``spec.cell`` applies them before a run has imported it):

  * its lattice: ``lattices/<lattice.geometry>.py``;
  * its model kind: ``kinds/<model.kind>.py`` on the hypercubic lattice and
    ``kinds/<model.kind>_<lattice.geometry>.py`` on any other (the same
    kind is another network there: the triangular GCNN's group is p6m).

Paths are relative to the root of a checkout.
"""
from __future__ import annotations

import importlib.util
import os

#: the reference's folder under a checkout's root
FOLDER = os.path.join("benchmark", "reference")


def geometry(cfg: dict) -> str:
    return cfg["lattice"].get("geometry", "hypercubic")


def kind_name(cfg: dict) -> str:
    """The configuration's kind file under ``kinds/``, without ``.py``."""
    name = cfg["model"]["kind"]
    geo = geometry(cfg)
    return name if geo == "hypercubic" else f"{name}_{geo}"


def kind_path(cfg: dict) -> str:
    return os.path.join(FOLDER, "kinds", f"{kind_name(cfg)}.py")


def lattice_path(cfg: dict) -> str:
    return os.path.join(FOLDER, "lattices", f"{geometry(cfg)}.py")


def load(path: str, module: str):
    """The module of the file at ``path``, loaded by path as ``module``."""
    mod_spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
