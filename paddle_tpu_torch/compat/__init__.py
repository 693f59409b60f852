"""The port's ``paddle`` import shim, for configs and data providers written
the reference's way.

Every demo config does ``from paddle.trainer_config_helpers import *`` and
every demo provider ``from paddle.trainer.PyDataProvider2 import *``. The
JAX package resolves those through the repository's ``compat/``, which
binds ``paddle`` to ``paddle_tpu``; this directory holds the port's own
``paddle`` package, which binds it to ``paddle_tpu_torch``.
:func:`paddle_shim` puts it first on ``sys.path`` while a config is parsed
or a provider module is imported, and evicts any cached ``paddle`` module
from elsewhere, with the local directories' own modules (a demo's
``sentiment_net`` or ``dataprovider`` binds whichever package imported it
first). Afterwards it puts back whatever ``sys.path`` and ``sys.modules``
held before, so the JAX package in the same process still gets its own.

Some demo modules also import the JAX package by name, lazily, inside the
functions that read a corpus (``from paddle_tpu.data import datasets``,
``demo/seqToseq/dataprovider.py:80``), and those run later, on the
feeder's threads. So the shim imports each local module with builtins of
its own (:data:`PORT_BUILTINS`) whose ``__import__`` renames
``paddle_tpu[.x]`` to ``paddle_tpu_torch[.x]``: every function of such a
module, on any thread and for as long as it lives, imports the port's
modules, while ``sys.modules`` keeps the JAX package's (if it is loaded)
for everyone else. Its limits: it covers ``import`` statements in the
modules loaded from the local directories (``importlib.import_module``
calls and modules found elsewhere on ``sys.path`` are not renamed), and a
local module first imported after the block ends is not loaded this way.
"""

from __future__ import annotations

import builtins
import contextlib
import importlib.abc
import importlib.machinery
import os
import sys
from typing import Optional

SHIM_DIR = os.path.dirname(os.path.realpath(__file__))

_real_import = builtins.__import__


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and (name == "paddle_tpu" or name.startswith("paddle_tpu.")):
        name = "paddle_tpu_torch" + name[len("paddle_tpu"):]
    return _real_import(name, globals, locals, fromlist, level)


PORT_BUILTINS = dict(vars(builtins), __import__=_import)


class _PortLoader(importlib.machinery.SourceFileLoader):
    """Executes a local module with :data:`PORT_BUILTINS`: the functions it
    defines take them along (CPython keeps a function's builtins from its
    globals at definition)."""

    def exec_module(self, module):
        module.__builtins__ = PORT_BUILTINS
        super().exec_module(module)


class _LocalFinder(importlib.abc.MetaPathFinder):
    """Finds top-level single-file modules in the shim's local directories
    and loads them with :class:`_PortLoader`."""

    def __init__(self, dirs):
        self.dirs = list(dirs)

    def find_spec(self, name, path=None, target=None):
        if "." in name:
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, self.dirs)
        if spec is None or type(spec.loader) is not importlib.machinery.SourceFileLoader:
            return None
        spec.loader = _PortLoader(spec.loader.name, spec.loader.path)
        return spec


def _is_paddle(name: str) -> bool:
    return name == "paddle" or name.startswith("paddle.")


def _under(module, directory: str) -> bool:
    path = getattr(module, "__file__", None)
    return path is not None and os.path.realpath(path).startswith(directory + os.sep)


def _local(name: str, module, dirs, shadowed) -> bool:
    """A top-level module (or its submodule) named like a ``.py`` file in one
    of ``dirs`` (``shadowed``), or loaded from a file directly in one."""
    path = getattr(module, "__file__", None)
    return (name.split(".")[0] in shadowed
            or ("." not in name and path is not None
                and os.path.dirname(os.path.realpath(path)) in dirs))


def _py_stems(directory: str):
    try:
        return {f[:-3] for f in os.listdir(directory) if f.endswith(".py")}
    except OSError:
        return set()


@contextlib.contextmanager
def paddle_shim(*local_dirs: Optional[str]):
    """Bind ``import paddle...`` to this shim inside the block, put
    ``local_dirs`` first on ``sys.path``, and give the modules in them a
    fresh import there, with :data:`PORT_BUILTINS`."""
    dirs = list(dict.fromkeys(os.path.realpath(d) for d in local_dirs if d))
    shadowed = set().union(*(_py_stems(d) for d in dirs))

    def isolated(name, module):
        return _is_paddle(name) or _local(name, module, dirs, shadowed)

    saved_path = list(sys.path)
    saved = {name: m for name, m in sys.modules.items() if isolated(name, m)}
    for name, m in saved.items():
        if not _under(m, SHIM_DIR):
            del sys.modules[name]
    front = [SHIM_DIR] + dirs
    sys.path[:] = front + [p for p in saved_path if p not in front]
    finder = _LocalFinder(dirs)
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        for name in [n for n, m in list(sys.modules.items()) if isolated(n, m)]:
            del sys.modules[name]
        sys.modules.update(saved)
        sys.path[:] = saved_path
