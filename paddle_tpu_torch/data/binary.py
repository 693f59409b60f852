"""Binary dataset format — the ProtoDataProvider role.

The reference's ProtoDataProvider (/root/reference/paddle/gserver/
dataproviders/ProtoDataProvider.h:49) reads pre-serialized protobuf
`DataFormat` files so training needn't re-run Python preprocessing. The
TPU-era analog: one `.pdz` (npz) shard per file holding column-packed
slots — ragged sequences stored flat + offsets — loaded with zero Python
per-sample work and streamed through the normal feeder/scanner path.

Write shards with ``write_shard``; configure with
``define_bin_data_sources(train_list, test_list, input_types=...)`` or
DataConfig(type="bin"). Each line of the file list names one shard.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.data.provider import DataType, InputType, SequenceType

MAGIC = "paddle_tpu.bin.v1"


def _type_dict(tp: InputType) -> Dict[str, int]:
    return {"dim": tp.dim, "seq_type": tp.seq_type, "type": tp.type}


def write_shard(path: str, samples: List[Sequence[Any]], input_types: Sequence[InputType]) -> None:
    """Column-pack ``samples`` (lists of per-slot values, @provider yield
    format) into one npz shard."""
    arrays: Dict[str, np.ndarray] = {}
    n = len(samples)
    for i, tp in enumerate(input_types):
        col = [s[i] for s in samples]
        if tp.seq_type == SequenceType.NO_SEQUENCE:
            if tp.type == DataType.Index:
                arrays[f"s{i}_data"] = np.asarray(col, dtype=np.int32)
            elif tp.type == DataType.Dense:
                arrays[f"s{i}_data"] = np.asarray(col, dtype=np.float32)
            else:  # sparse rows: flat ids (+values) with offsets
                offs = np.zeros(n + 1, np.int64)
                flat_i: List[int] = []
                flat_v: List[float] = []
                for j, row in enumerate(col):
                    if tp.type == DataType.SparseValue:
                        flat_i.extend(int(p[0]) for p in row)
                        flat_v.extend(float(p[1]) for p in row)
                    else:
                        flat_i.extend(int(x) for x in row)
                    offs[j + 1] = len(flat_i)
                arrays[f"s{i}_ids"] = np.asarray(flat_i, dtype=np.int64)
                arrays[f"s{i}_offs"] = offs
                if tp.type == DataType.SparseValue:
                    arrays[f"s{i}_vals"] = np.asarray(flat_v, dtype=np.float32)
        elif tp.seq_type == SequenceType.SEQUENCE:
            offs = np.zeros(n + 1, np.int64)
            flat: List[Any] = []
            for j, seq in enumerate(col):
                flat.extend(seq)
                offs[j + 1] = len(flat)
            dtype = np.int32 if tp.type == DataType.Index else np.float32
            arrays[f"s{i}_data"] = np.asarray(flat, dtype=dtype)
            arrays[f"s{i}_offs"] = offs
        else:
            # nested sequences (ref ProtoDataProvider subseq handling,
            # ProtoDataProvider.h:49): two offset levels — sub_offs maps
            # each SUBSEQUENCE to its flat token range, offs maps each
            # sample to its subsequence range
            offs = np.zeros(n + 1, np.int64)
            sub_offs: List[int] = [0]
            flat = []
            for j, subseqs in enumerate(col):
                for seq in subseqs:
                    flat.extend(seq)
                    sub_offs.append(len(flat))
                offs[j + 1] = len(sub_offs) - 1
            dtype = np.int32 if tp.type == DataType.Index else np.float32
            arrays[f"s{i}_data"] = np.asarray(flat, dtype=dtype)
            arrays[f"s{i}_offs"] = offs
            arrays[f"s{i}_sub_offs"] = np.asarray(sub_offs, dtype=np.int64)
    meta = {"magic": MAGIC, "n": n, "types": [_type_dict(t) for t in input_types]}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    # np.savez appends .npz to a bare path; write through a file object so
    # a '.pdz' shard lands at exactly the path the file list names
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def read_shard(path: str):
    """Yield samples from a shard in @provider format."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        assert meta["magic"] == MAGIC, f"{path}: not a paddle_tpu binary shard"
        types = [InputType(t["dim"], t["seq_type"], t["type"]) for t in meta["types"]]
        arrays = {k: z[k] for k in z.files}
    n = meta["n"]
    for j in range(n):
        sample = []
        for i, tp in enumerate(types):
            if tp.seq_type == SequenceType.NO_SEQUENCE:
                if tp.type in (DataType.Index, DataType.Dense):
                    sample.append(arrays[f"s{i}_data"][j])
                else:
                    lo, hi = arrays[f"s{i}_offs"][j], arrays[f"s{i}_offs"][j + 1]
                    ids = arrays[f"s{i}_ids"][lo:hi]
                    if tp.type == DataType.SparseValue:
                        vals = arrays[f"s{i}_vals"][lo:hi]
                        sample.append(list(zip(ids.tolist(), vals.tolist())))
                    else:
                        sample.append(ids.tolist())
            elif tp.seq_type == SequenceType.SEQUENCE:
                lo, hi = arrays[f"s{i}_offs"][j], arrays[f"s{i}_offs"][j + 1]
                sample.append(arrays[f"s{i}_data"][lo:hi].tolist())
            else:  # nested: sample -> subseq range -> token ranges
                lo, hi = arrays[f"s{i}_offs"][j], arrays[f"s{i}_offs"][j + 1]
                so = arrays[f"s{i}_sub_offs"]
                sample.append(
                    [
                        arrays[f"s{i}_data"][so[s] : so[s + 1]].tolist()
                        for s in range(int(lo), int(hi))
                    ]
                )
        yield sample


def shard_input_types(path: str) -> List[InputType]:
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    return [InputType(t["dim"], t["seq_type"], t["type"]) for t in meta["types"]]


class BinaryProvider:
    """@provider-shaped adapter over binary shards (duck-types the object
    the feeder consumes: .init()/.generator_fn/flags)."""

    should_shuffle = None
    pool_size = -1
    min_pool_size = -1
    can_over_batch_size = True
    calc_batch_size = None
    cache = 0
    name = "binary"

    def __init__(self, first_shard: str):
        self.input_types = shard_input_types(first_shard)

    def init(self, **kwargs):
        from paddle_tpu_torch.data.provider import _ProviderSettings

        settings = _ProviderSettings()
        settings.input_types = self.input_types
        settings.should_shuffle = None
        return settings

    @staticmethod
    def generator_fn(settings, file_name):
        yield from read_shard(file_name)
