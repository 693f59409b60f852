"""Data source declaration (reference: trainer_config_helpers/
data_sources.py define_py_data_sources2): binds train/test file lists to a
python @provider module.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

from paddle_tpu_torch.config.builder import current_context
from paddle_tpu_torch.proto import DataConfig

__all__ = ["define_py_data_sources2", "define_bin_data_sources", "define_multi_py_data_sources2"]


def _encode_args(args: Any) -> str:
    if args is None:
        return ""
    import json

    return json.dumps(args)


def define_py_data_sources2(
    train_list: Optional[str],
    test_list: Optional[str],
    module,
    obj,
    args: Optional[Dict] = None,
) -> None:
    ctx = current_context()
    train_module = module[0] if isinstance(module, (list, tuple)) else module
    test_module = module[1] if isinstance(module, (list, tuple)) else module
    train_obj = obj[0] if isinstance(obj, (list, tuple)) else obj
    test_obj = obj[1] if isinstance(obj, (list, tuple)) else obj
    if train_list is not None:
        ctx.trainer_config.data_config = DataConfig(
            type="py2",
            files=train_list,
            load_data_module=train_module,
            load_data_object=train_obj,
            load_data_args=_encode_args(args),
        )
    if test_list is not None:
        ctx.trainer_config.test_data_config = DataConfig(
            type="py2",
            files=test_list,
            load_data_module=test_module,
            load_data_object=test_obj,
            load_data_args=_encode_args(args),
            for_test=True,
        )


def define_bin_data_sources(train_list, test_list=None):
    """Binary-shard data sources (the ProtoData role,
    paddle_tpu_torch.data.binary): file lists name .npz shards written by
    write_shard; slot types come from the shard metadata."""
    ctx = current_context()
    if train_list is not None:
        ctx.trainer_config.data_config = DataConfig(type="bin", files=train_list)
    if test_list is not None:
        ctx.trainer_config.test_data_config = DataConfig(type="bin", files=test_list)


def define_multi_py_data_sources2(
    train_lists, module, obj, args_list=None, ratios=None, test_list=None,
    test_module=None, test_obj=None,
):
    """Ratio-mixed multi-provider training data (the MultiDataProvider
    role): each entry of ``train_lists`` gets its own @provider
    (module/obj may be a single name shared by all, or parallel lists) and
    contributes data_ratio samples per mixing round."""
    n = len(train_lists)
    modules = module if isinstance(module, (list, tuple)) else [module] * n
    objs = obj if isinstance(obj, (list, tuple)) else [obj] * n
    if args_list is None or isinstance(args_list, dict):
        args_list = [args_list] * n
    ratios = [1] * n if ratios is None else list(ratios)
    for nm, val in (("module", modules), ("obj", objs),
                    ("args_list", args_list), ("ratios", ratios)):
        assert len(val) == n, (
            f"define_multi_py_data_sources2: {nm} has {len(val)} entries "
            f"for {n} train_lists"
        )
    subs = []
    for files, m, o, a, r in zip(train_lists, modules, objs, args_list, ratios):
        subs.append(DataConfig(
            type="py2", files=files, load_data_module=m, load_data_object=o,
            load_data_args=_encode_args(a), data_ratio=int(r),
        ))
    ctx = current_context()
    ctx.trainer_config.data_config = DataConfig(type="multi", sub_data_configs=subs)
    if test_list is not None:
        ctx.trainer_config.test_data_config = DataConfig(
            type="py2", files=test_list,
            load_data_module=test_module or modules[0],
            load_data_object=test_obj or objs[0],
        )
