"""Optional host packages (matplotlib, imageio, OpenCV), imported where a
tool uses one.  A missing package raises an ``ImportError`` that names it
and the tool that needs it, at that point; no tool switches to another
writer."""

from __future__ import annotations

import importlib


def require(module: str, needed_by: str):
    """``import module``; where it is not installed, an ``ImportError``
    (``name=module``) saying that ``needed_by`` needs it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{needed_by} needs {module}, which is not installed", name=module) from e
