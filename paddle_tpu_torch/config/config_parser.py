"""parse_config — execute a user config script into a TrainerConfig.

Role of the reference's config_parser.parse_config
(/root/reference/python/paddle/trainer/config_parser.py:3056): runs the
user's config .py in a namespace pre-seeded with the DSL, collects the
layer/parameter/optimization records from the build context, and returns
the finished TrainerConfig. ``--config_args k=v,k2=v2`` values are exposed
through ``get_config_arg``.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, Optional, Union

from paddle_tpu_torch.config.builder import current_context, fresh_context
from paddle_tpu_torch.proto import TrainerConfig


def get_config_arg(name: str, type_: type = str, default=None):
    """Read a --config_args value (reference: config_parser get_config_arg)."""
    ctx = current_context()
    if name not in ctx.config_args:
        return default
    v = ctx.config_args[name]
    if type_ is bool:
        return str(v).lower() in ("1", "true", "yes", "on")
    return type_(v)


def _parse_config_args(config_arg_str: str) -> Dict[str, str]:
    args: Dict[str, str] = {}
    if config_arg_str:
        for pair in config_arg_str.split(","):
            if not pair.strip():
                continue
            k, _, v = pair.partition("=")
            args[k.strip()] = v.strip()
    return args


def _ensure_compat_path() -> None:
    """Make `import paddle.trainer_config_helpers` resolve to our shim."""
    shim_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "compat")
    if os.path.isdir(shim_dir) and shim_dir not in sys.path:
        sys.path.insert(0, shim_dir)


def evict_shadowed_modules(directory: str) -> None:
    """Drop cached top-level modules that are shadowed by same-named .py files
    in ``directory``, so user configs always import their *local* helper
    modules (two demos both ship a ``dataprovider.py``; the reference runs
    each config in a fresh embedded interpreter so never hits this)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return
    for fname in entries:
        if not fname.endswith(".py"):
            continue
        stem = fname[:-3]
        mod = sys.modules.get(stem)
        if mod is None:
            continue
        modfile = getattr(mod, "__file__", None)
        local = os.path.join(os.path.realpath(directory), fname)
        if modfile is None or os.path.realpath(modfile) != local:
            for k in list(sys.modules):
                if k == stem or k.startswith(stem + "."):
                    del sys.modules[k]


def parse_config(
    config: Union[str, Callable[[], None]],
    config_arg_str: str = "",
) -> TrainerConfig:
    """Execute ``config`` (a script path or a callable) and return the built
    TrainerConfig."""
    with fresh_context() as ctx:
        ctx.config_args = _parse_config_args(config_arg_str)
        if callable(config):
            config()
        else:
            import paddle_tpu_torch.trainer_config_helpers as tch

            namespace = {"__file__": config, "__name__": "__paddle_tpu_config__"}
            for k in dir(tch):
                if not k.startswith("_"):
                    namespace[k] = getattr(tch, k)
            namespace["get_config_arg"] = get_config_arg
            config_dir = os.path.dirname(os.path.abspath(config))
            evict_shadowed_modules(config_dir)
            added = False
            if config_dir not in sys.path:
                sys.path.insert(0, config_dir)
                added = True
            try:
                with open(config) as f:
                    code = compile(f.read(), config, "exec")
                exec(code, namespace)
            finally:
                if added:
                    sys.path.remove(config_dir)
            ctx.trainer_config.config_files.append(config)
        return ctx.finalize()


def parse_config_at(config_path: str, config_arg_str: str = "") -> TrainerConfig:
    """parse_config with cwd temporarily set to the config's directory, so
    configs using relative file lists / local imports work from anywhere."""
    config_path = os.path.abspath(config_path)
    cwd = os.getcwd()
    os.chdir(os.path.dirname(config_path))
    try:
        return parse_config(os.path.basename(config_path), config_arg_str)
    finally:
        os.chdir(cwd)


def parse_config_and_serialize(config, config_arg_str: str = "") -> str:
    """JSON form (the reference returned serialized protobuf bytes)."""
    return parse_config(config, config_arg_str).to_json()
