"""Architecture registry of the port (``--arch <id>``): the dense llama
family only.  ``get`` is the published configuration, ``smoke`` a reduced
one of the same family for CPU runs."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import llama3_2_1b

_ARCHS = {"llama3.2-1b": llama3_2_1b}


def _module(name: str):
    key = name.replace("_", "-")
    for arch, mod in _ARCHS.items():
        if arch.replace("_", "-") == key or arch.replace(".", "-") == key:
            return mod
    raise KeyError(f"unknown arch {name!r}; the port serves {names()}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def names() -> tuple:
    return tuple(_ARCHS)
