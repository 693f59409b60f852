"""Checkpointing — ``pass-%05d`` directories with parameters and optimizer state.

Port of the single-host format of ``paddle_tpu/trainer/checkpoint.py``,
byte-compatible both ways: one ``.npz`` for the parameters
(``params.npz``), one per optimizer tree (``optimizer_slots.npz``, keys
``<param>/<slot>``; ``optimizer_avg.npz`` and ``optimizer_avg_old.npz``
when parameter averaging is on), ``meta.json`` with the pass id and the
optimizer counters, and the CRC32/size ``MANIFEST.json``
(:mod:`paddle_tpu_torch.resilience.manifest`).

A save writes everything into ``pass-%05d.tmp``, fsyncs each file,
records the manifest, and only then renames the directory into place; an
earlier save of the same pass is removed only after the rename, and old
passes beyond ``keep`` are rotated away. A load verifies the manifest
first and raises :class:`~paddle_tpu_torch.resilience.CheckpointCorruptError`
on a mismatch. :func:`find_restorable_checkpoint` backs
``--init_model_path=auto``. The multi-host sharded format
(``<tree>.index.json``) and the fallback chain to earlier passes are a
later slice.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.optimizer.updater import UpdaterState
from paddle_tpu_torch.resilience import CheckpointCorruptError
from paddle_tpu_torch.resilience import manifest as ckpt_manifest
from paddle_tpu_torch.utils.logging import logger

PASS_FMT = "pass-%05d"
TMP_SUFFIX = ".tmp"

Params = Dict[str, torch.Tensor]


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of tensors -> {'a/b': numpy array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        elif v is not None:
            out[key] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _fsync_dir(path: str) -> None:
    """Make a directory entry durable (best-effort: not every filesystem
    supports a directory fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_file(path: str, writer: Callable, mode: str = "wb") -> None:
    with open(path, mode) as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def _is_pass_dir_name(d: str) -> bool:
    return d.startswith("pass-") and d[5:].isdigit()


def _save_trees(pass_id: int, params: Params, opt_state: Optional[UpdaterState],
                extra_meta: Optional[Dict[str, Any]] = None):
    """(trees, meta) of one save, in the JAX package's single-host layout."""
    trees: Dict[str, Dict[str, np.ndarray]] = {"params": _flatten(params)}
    meta: Dict[str, Any] = {"pass_id": pass_id, "format_version": 1}
    if opt_state is not None:
        trees["optimizer_slots"] = _flatten(opt_state.slots)
        if opt_state.avg_sum is not None:
            trees["optimizer_avg"] = _flatten(opt_state.avg_sum)
        if opt_state.avg_old_sum is not None:
            trees["optimizer_avg_old"] = _flatten(opt_state.avg_old_sum)
        meta["optimizer"] = {
            "step": int(opt_state.step),
            "num_samples": float(opt_state.num_samples),
            "avg_count": float(opt_state.avg_count),
            "avg_old_count": float(opt_state.avg_old_count or 0.0),
        }
    if extra_meta:
        meta.update(extra_meta)
    return trees, meta


def save_checkpoint(save_dir: str, pass_id: int, params: Params,
                    opt_state: Optional[UpdaterState] = None, keep: int = 3,
                    extra_meta: Optional[Dict[str, Any]] = None,
                    protect_pass: Optional[int] = None) -> str:
    """Save one pass directory atomically; returns its path. ``extra_meta``
    goes into ``meta.json``; ``protect_pass`` (the pass a run restored
    from) is never rotated away."""
    final = os.path.join(save_dir, PASS_FMT % pass_id)
    tmp = final + TMP_SUFFIX
    os.makedirs(save_dir, exist_ok=True)
    # a stale .tmp is a crashed earlier attempt at this pass
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    trees, meta = _save_trees(pass_id, params, opt_state, extra_meta)
    for base, flat in trees.items():
        _write_file(os.path.join(tmp, f"{base}.npz"), lambda f, _flat=flat: np.savez(f, **_flat))
    _write_file(os.path.join(tmp, "meta.json"), lambda f: json.dump(meta, f, indent=2), mode="w")
    ckpt_manifest.write_manifest(tmp)
    _commit(tmp, final)
    _rotate(save_dir, keep, protect_pass)
    logger.info("saved checkpoint %s", final)
    return final


def _commit(tmp: str, final: str) -> None:
    """Publish a complete tmp dir as the final pass dir. A re-save of the
    same pass moves the old dir aside and drops it only after the rename,
    so one complete checkpoint of the pass exists at every instant."""
    _fsync_dir(tmp)
    old = None
    if os.path.lexists(final):
        old = final + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(final, old)
    os.rename(tmp, final)
    _fsync_dir(os.path.dirname(final) or ".")
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def _rotate(save_dir: str, keep: int, protect: Optional[int] = None) -> None:
    """Rolling deletion of old pass dirs; stale .tmp / .old dirs are swept,
    but for the .old of ``protect``, which is never rolled away either."""
    names = os.listdir(save_dir)
    for d in names:
        if d.startswith("pass-") and (d.endswith(TMP_SUFFIX) or d.endswith(".old")):
            if protect is not None and d == (PASS_FMT % protect) + ".old":
                continue
            shutil.rmtree(os.path.join(save_dir, d), ignore_errors=True)
    if keep <= 0:
        return
    for p in _passes(names)[:-keep]:
        if p != protect:
            shutil.rmtree(os.path.join(save_dir, PASS_FMT % p), ignore_errors=True)


def has_params_tree(path: str) -> bool:
    """True if a pass dir holds a params tree in either format."""
    return (os.path.exists(os.path.join(path, "params.npz"))
            or os.path.exists(os.path.join(path, "params.index.json")))


def _passes(names: List[str]) -> List[int]:
    """The pass ids of the complete pass dirs among ``names``, ascending."""
    return sorted(int(d[5:]) for d in names if _is_pass_dir_name(d))


def latest_pass(save_dir: str) -> Optional[int]:
    """The newest complete pass in ``save_dir``; None if there is none."""
    passes = _passes(os.listdir(save_dir)) if os.path.isdir(save_dir) else []
    return passes[-1] if passes else None


def verify_checkpoint(path: str) -> List[str]:
    """Problems with one pass directory; an empty list means restorable."""
    if not os.path.isdir(path):
        return [f"{path}: not a directory"]
    problems = []
    if not os.path.exists(os.path.join(path, "params.npz")):
        problems.append("no params tree (params.npz)")
    return problems + ckpt_manifest.verify_dir(path)


def find_restorable_checkpoint(save_dir: str) -> Optional[str]:
    """Newest pass dir under ``save_dir`` that verifies clean, or None.
    Read-only: corrupt candidates are logged and skipped. The last resort
    is a ``pass-NNNNN.old`` that a crash between ``_commit``'s two renames
    left behind (once published, so complete); never a ``.tmp``."""
    if not os.path.isdir(save_dir):
        return None
    names = os.listdir(save_dir)
    for p in reversed(_passes(names)):
        path = os.path.join(save_dir, PASS_FMT % p)
        problems = verify_checkpoint(path)
        if not problems:
            return path
        logger.warning("find_restorable_checkpoint: skipping %s: %s", path, "; ".join(problems))
    for d in sorted((d for d in names if d.endswith(".old") and _is_pass_dir_name(d[:-4])),
                    reverse=True):
        path = os.path.join(save_dir, d)
        if not verify_checkpoint(path):
            logger.warning("find_restorable_checkpoint: recovering from torn commit "
                           "leftover %s", path)
            return path
    return None


def load_checkpoint(path: str, opt_template: Optional[UpdaterState] = None,
                    device: DeviceLike = None, expected_params: Optional[Params] = None,
                    missing: str = "fail",
                    ) -> Tuple[Params, Optional[UpdaterState], Dict[str, Any]]:
    """Load params (and the optimizer state, rebuilt onto ``opt_template``)
    onto ``device`` after verifying the manifest. ``missing`` is the
    reference's --load_missing_parameter_strategy for a parameter of
    ``expected_params`` the checkpoint lacks: ``fail`` raises, ``rand``
    keeps the expected (freshly initialised) value, ``zero`` zeros it."""
    path = os.path.normpath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    if os.path.exists(os.path.join(path, "params.index.json")):
        raise NotImplementedError(
            f"{path} is in the multi-host sharded format, which is not ported yet")
    problems = verify_checkpoint(path)
    if problems:
        raise CheckpointCorruptError(f"{path}: {'; '.join(problems)}", problems=problems)
    dev = resolve_device(device)

    def load_tree(base: str) -> Optional[Dict[str, torch.Tensor]]:
        npz = os.path.join(path, f"{base}.npz")
        if not os.path.exists(npz):
            return None
        with np.load(npz) as z:
            return {k: torch.from_numpy(np.array(z[k])).to(dev) for k in z.files}

    params = load_tree("params")
    if expected_params is not None:
        absent = sorted(set(expected_params) - set(params))
        if absent and missing == "fail":
            raise KeyError(f"parameters {absent} missing from checkpoint {path}")
        for name in absent:
            val = expected_params[name].to(dev)
            params[name] = torch.zeros_like(val) if missing == "zero" else val
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    opt_state = None
    slot_vals = load_tree("optimizer_slots") if opt_template is not None else None
    if slot_vals is not None:
        om = meta.get("optimizer", {})
        avg_sum = opt_template.avg_sum
        if avg_sum is not None:
            avg_sum = load_tree("optimizer_avg") or avg_sum
        avg_old_sum = opt_template.avg_old_sum
        if avg_old_sum is not None:
            avg_old_sum = load_tree("optimizer_avg_old") or avg_old_sum
        opt_state = UpdaterState(
            step=int(om.get("step", 0)),
            num_samples=float(om.get("num_samples", 0.0)),
            slots=_unflatten(slot_vals),
            avg_sum=avg_sum,
            avg_count=float(om.get("avg_count", 0.0)),
            avg_old_sum=avg_old_sum,
            avg_old_count=float(om.get("avg_old_count", 0.0)),
        )
    logger.info("loaded checkpoint %s", path)
    return params, opt_state, meta
