"""@provider — the user data-ingestion contract.

API-compatible with the reference's PyDataProvider2
(/root/reference/python/paddle/trainer/PyDataProvider2.py:33-190): a user
function yields one sample at a time (list/dict of slot values); the
decorator attaches input-type declarations and behavior knobs. The runtime
side (feeder.py) pulls samples, shuffles, batches and pads them into
Argument pytrees.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Union

__all__ = [
    "SequenceType",
    "DataType",
    "CacheType",
    "InputType",
    "dense_slot",
    "sparse_non_value_slot",
    "sparse_value_slot",
    "index_slot",
    "dense_vector",
    "sparse_binary_vector",
    "sparse_vector",
    "integer_value",
    "dense_vector_sequence",
    "dense_vector_sub_sequence",
    "sparse_binary_vector_sequence",
    "sparse_binary_vector_sub_sequence",
    "sparse_vector_sequence",
    "sparse_vector_sub_sequence",
    "integer_value_sequence",
    "integer_value_sub_sequence",
    "integer_sequence",
    "provider",
]


class SequenceType:
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


class DataType:
    Dense = 0
    SparseNonValue = 1
    SparseValue = 2
    Index = 3


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class InputType:
    __slots__ = ["dim", "seq_type", "type"]

    def __init__(self, dim: int, seq_type: int, tp: int):
        self.dim = dim
        self.seq_type = seq_type
        self.type = tp

    def __repr__(self):
        return f"InputType(dim={self.dim}, seq_type={self.seq_type}, type={self.type})"


def dense_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.Dense)


def sparse_non_value_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseNonValue)


def sparse_value_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseValue)


def index_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.Index)


dense_vector = dense_slot
sparse_binary_vector = sparse_non_value_slot
sparse_vector = sparse_value_slot
integer_value = index_slot


def dense_vector_sequence(dim):
    return dense_vector(dim, seq_type=SequenceType.SEQUENCE)


def dense_vector_sub_sequence(dim):
    return dense_vector(dim, seq_type=SequenceType.SUB_SEQUENCE)


def sparse_binary_vector_sequence(dim):
    return sparse_binary_vector(dim, seq_type=SequenceType.SEQUENCE)


def sparse_binary_vector_sub_sequence(dim):
    return sparse_binary_vector(dim, seq_type=SequenceType.SUB_SEQUENCE)


def sparse_vector_sequence(dim):
    return sparse_vector(dim, seq_type=SequenceType.SEQUENCE)


def sparse_vector_sub_sequence(dim):
    return sparse_vector(dim, seq_type=SequenceType.SUB_SEQUENCE)


def integer_value_sequence(dim):
    return integer_value(dim, seq_type=SequenceType.SEQUENCE)


def integer_value_sub_sequence(dim):
    return integer_value(dim, seq_type=SequenceType.SUB_SEQUENCE)


def integer_sequence(dim):
    return index_slot(dim, seq_type=SequenceType.SEQUENCE)


class _ProviderSettings:
    """The `settings` object handed to init_hook/process (attribute bag)."""

    def __init__(self):
        self.input_types = None
        self.should_shuffle = None
        self.pool_size = -1
        self.sort_by_length = False
        self.logger = None

    def __setattr__(self, k, v):
        object.__setattr__(self, k, v)


def provider(
    input_types=None,
    should_shuffle: Optional[bool] = None,
    pool_size: int = -1,
    min_pool_size: int = -1,
    can_over_batch_size: bool = True,
    calc_batch_size: Optional[Callable] = None,
    cache: int = CacheType.NO_CACHE,
    init_hook: Optional[Callable] = None,
    sort_by_length: bool = False,
    **outter_kwargs,
):
    """Decorate a sample generator ``fn(settings, filename)``.

    The decorated object exposes the declaration (`input_types`, flags) and
    an ``open(filename)`` iterator used by the runtime feeder.

    ``sort_by_length`` is a TPU-native extension (doc/divergences.md): the
    training feeder length-sorts each shuffle pool before slicing batches
    (batch ORDER stays shuffled), so a batch's padded length is set by
    similar-length neighbors instead of the pool max — the static-shape
    answer to the reference's no-padding SequenceToBatch packing
    (SequenceToBatch.h:41). Test/generation order is never changed.
    """

    def deco(fn):
        class PyDataProvider2:
            # attributes inspected by the feeder
            pass

        p = PyDataProvider2()
        p.generator_fn = fn
        p.input_types = input_types
        # None = decided by the consumer: shuffle for training, ordered for
        # test/gen (reference PyDataProvider2 semantics)
        p.should_shuffle = should_shuffle
        p.pool_size = pool_size
        p.min_pool_size = min_pool_size
        p.can_over_batch_size = can_over_batch_size
        p.calc_batch_size = calc_batch_size
        p.cache = cache
        p.sort_by_length = sort_by_length
        p.init_hook = init_hook
        p.outter_kwargs = outter_kwargs
        p.name = fn.__name__

        def init(**kwargs):
            settings = _ProviderSettings()
            settings.input_types = p.input_types
            settings.should_shuffle = p.should_shuffle
            settings.pool_size = p.pool_size
            settings.sort_by_length = p.sort_by_length
            import logging

            settings.logger = logging.getLogger("paddle_tpu_torch.data")
            if init_hook is not None:
                # the runtime injects file_list/is_train (reference
                # PyDataProvider2.py:161-178 contract); hooks without a
                # **kwargs catch-all only receive the names they declare
                import inspect

                sig = inspect.signature(init_hook)
                if not any(
                    p.kind == p.VAR_KEYWORD for p in sig.parameters.values()
                ):
                    kwargs = {k: v for k, v in kwargs.items() if k in sig.parameters}
                init_hook(settings, **kwargs)
            if settings.input_types is None:
                raise ValueError(
                    f"provider {fn.__name__}: input_types not declared "
                    "(pass to @provider or set in init_hook)"
                )
            return settings

        p.init = init

        functools.update_wrapper(p.__class__, fn, updated=[])
        return p

    return deco
