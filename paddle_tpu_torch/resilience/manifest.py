"""Per-file CRC32/size manifests for checkpoint directories.

``MANIFEST.json`` makes a pass directory self-verifying: every data file
is recorded with its byte size and CRC32, so a torn write, a truncated
shard, or shared-filesystem bit rot is detected *before* a restore
deserializes garbage into live training state. Format:

    {"format": 1,
     "files": {"params.npz": {"size": 1234, "crc32": 305419896}, ...}}

Multi-host saves cannot have process 0 re-read every shard just to
checksum it, so each process writes a ``MANIFEST.partial.<pid>.json``
covering only the files it wrote (data it just produced, a local
read-back), and process 0 merges the partials — the same
partial-then-merge discipline the sharded index already uses.

The manifest never lists itself, and verification ignores files absent
from it (a later tool dropping e.g. ``merged_model.npz`` into a pass dir
must not invalidate the checkpoint).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Iterable, List, Optional

MANIFEST_NAME = "MANIFEST.json"
_PARTIAL_FMT = "MANIFEST.partial.%05d.json"
_CHUNK = 1 << 20


def file_digest(path: str) -> Dict[str, int]:
    """{'size': bytes, 'crc32': unsigned crc} of one file, streamed."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            size += len(chunk)
            crc = zlib.crc32(chunk, crc)
    return {"size": size, "crc32": crc & 0xFFFFFFFF}


def _is_manifest_file(name: str) -> bool:
    return name == MANIFEST_NAME or name.startswith("MANIFEST.partial.")


def build_manifest(dirpath: str, files: Optional[Iterable[str]] = None) -> Dict:
    """Digest ``files`` (default: every regular file in ``dirpath``
    except manifests) into a manifest dict."""
    if files is None:
        files = [
            n
            for n in sorted(os.listdir(dirpath))
            if not _is_manifest_file(n)
            and os.path.isfile(os.path.join(dirpath, n))
        ]
    return {
        "format": 1,
        "files": {n: file_digest(os.path.join(dirpath, n)) for n in files},
    }


def _write_json_fsync(path: str, obj: Dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())


def write_manifest(dirpath: str, manifest: Optional[Dict] = None) -> Dict:
    """Write (building if needed) ``MANIFEST.json``; fsynced."""
    if manifest is None:
        manifest = build_manifest(dirpath)
    _write_json_fsync(os.path.join(dirpath, MANIFEST_NAME), manifest)
    return manifest


def write_partial_manifest(dirpath: str, pid: int, files: Iterable[str]) -> None:
    """One process's share of a multi-host manifest: digests of the
    files this process wrote (local read-back of its own data)."""
    _write_json_fsync(
        os.path.join(dirpath, _PARTIAL_FMT % pid), build_manifest(dirpath, files)
    )


def merge_partial_manifests(dirpath: str) -> Dict:
    """Process 0, after the shard barrier: union the partials, digest
    any remaining un-covered files (merged indexes, meta.json — all
    process-0-local writes), drop the partials, write MANIFEST.json."""
    merged: Dict[str, Dict[str, int]] = {}
    partials = [
        n for n in sorted(os.listdir(dirpath)) if n.startswith("MANIFEST.partial.")
    ]
    for n in partials:
        with open(os.path.join(dirpath, n)) as f:
            merged.update(json.load(f).get("files", {}))
    for n in sorted(os.listdir(dirpath)):
        full = os.path.join(dirpath, n)
        if n not in merged and not _is_manifest_file(n) and os.path.isfile(full):
            merged[n] = file_digest(full)
    manifest = {"format": 1, "files": merged}
    write_manifest(dirpath, manifest)
    # partials dropped only AFTER the merged manifest is durable, so a
    # retried merge (transient write error) still finds its inputs
    for n in partials:
        os.remove(os.path.join(dirpath, n))
    return manifest


def read_manifest(dirpath: str) -> Optional[Dict]:
    """The parsed manifest, or None when absent/unreadable (an
    unreadable manifest is reported by verify_dir, not here)."""
    path = os.path.join(dirpath, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_dir(dirpath: str) -> List[str]:
    """Problems found checking ``dirpath`` against its manifest; empty
    list = verified clean. A directory WITHOUT a manifest verifies clean
    (pre-resilience checkpoints must keep loading) — callers that want
    to surface that distinction use ``read_manifest`` directly."""
    path = os.path.join(dirpath, MANIFEST_NAME)
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        # vanished after the exists() check: concurrent delete, a
        # verification problem rather than a crash
        return [f"{MANIFEST_NAME}: vanished while verifying (concurrent delete?)"]
    except ValueError as e:
        # corrupt JSON is real corruption; transient OSErrors propagate
        # so the caller's retry policy gets a chance before a good
        # checkpoint is condemned
        return [f"{MANIFEST_NAME} unreadable: {e}"]
    problems: List[str] = []
    for name, want in sorted(manifest.get("files", {}).items()):
        full = os.path.join(dirpath, name)
        if not os.path.exists(full):
            problems.append(f"{name}: missing (manifest says {want['size']} bytes)")
            continue
        try:
            got = file_digest(full)
        except FileNotFoundError:
            # vanished between the exists() check and the read — another
            # process rotated/quarantined the dir out from under us; a
            # verification problem, not a crash (other OSErrors propagate
            # so the caller's retry policy can handle transients)
            problems.append(f"{name}: vanished while verifying (concurrent delete?)")
            continue
        if got["size"] != want["size"]:
            problems.append(
                f"{name}: size {got['size']} != manifest {want['size']} (truncated?)"
            )
        elif got["crc32"] != want["crc32"]:
            problems.append(
                f"{name}: crc32 {got['crc32']:#010x} != manifest "
                f"{want['crc32']:#010x} (corrupted)"
            )
    return problems
