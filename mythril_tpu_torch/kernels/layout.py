"""Slot indices shared by the CUDA kernels and their Python wrappers.

`layout.cuh` is the single source of truth; this module parses its
`NAME = number,` lines at import, so a slot can never mean one thing to a
kernel and another to the wrapper that fills it."""

from __future__ import annotations

import os
import re

_PATH = os.path.join(os.path.dirname(__file__), "layout.cuh")


def _parse(path: str) -> dict:
    with open(path, encoding="utf-8") as handle:
        text = handle.read()
    return {name: int(value) for name, value in
            re.findall(r"^\s*([A-Z][A-Z0-9_]*)\s*=\s*(\d+),", text, re.M)}


SLOTS = _parse(_PATH)
globals().update(SLOTS)
