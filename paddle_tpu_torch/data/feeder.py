"""Batch assembly and the host-side data pipeline.

Port of ``paddle_tpu/data/feeder.py`` (the role of the reference's
DataProvider/DoubleBuffer machinery,
paddle/gserver/dataproviders/DataProvider.h:59,245,286 and
the PyDataProvider2.cpp:176 scanners): pulls samples from a @provider
generator, shuffles in a pool, packs padded numpy batches (the scanner
role), and prefetches on background threads so the device step never
waits on Python. The batches equal the JAX package's, batch for batch:
the same pool, shuffle (``random.Random(seed)``), length sort, bucketing
and packers. Each field is the packed numpy array itself, wrapped as a CPU
tensor (``torch.from_numpy``, no copy) in the port's
:class:`~paddle_tpu_torch.graph.argument.Argument`; the trainer moves a
batch to the card.

Padding uses *bucketed* sequence lengths (:func:`bucket_length`, a
multiple of 8 up to 64, then powers of two), as in the JAX package, where
they bound its recompiles; here they bound the shapes the kernels see.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import queue
import random
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.compat import paddle_shim
from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.data.provider import DataType, SequenceType
from paddle_tpu_torch.native import ptr
from paddle_tpu_torch.observability import metrics as obs
from paddle_tpu_torch.observability import spans as obs_spans
from paddle_tpu_torch.proto import DataConfig
from paddle_tpu_torch.resilience import BadSampleError, DataStallError
from paddle_tpu_torch.resilience.faultinject import fault_point
from paddle_tpu_torch.utils import concurrency as cc
from paddle_tpu_torch.utils.logging import logger
from paddle_tpu_torch.utils.retry import RetryPolicy


def bucket_length(n: int, multiple: int = 8) -> int:
    """Round up to limit distinct padded shapes: next multiple of
    ``multiple`` below 64, else next power of two."""
    n = max(n, 1)
    if n <= 64:
        return ((n + multiple - 1) // multiple) * multiple
    p = 64
    while p < n:
        p *= 2
    return p


def _argument(**fields: np.ndarray) -> Argument:
    """An Argument over the packed numpy arrays, as CPU tensors."""
    return Argument(**{k: torch.from_numpy(v) for k, v in fields.items()})


def _flat_i32(seqs, total: int) -> np.ndarray:
    return np.fromiter(itertools.chain.from_iterable(seqs), dtype=np.int32, count=total)


class BatchAssembler:
    """Packs a list of samples (per @provider input_types) into Arguments.

    The packing hot loops (the reference's C++ field scanners,
    PyDataProvider2.cpp:611-865) run in the native datapath library when it
    is available — ctypes calls release the GIL, so the prefetch thread
    packs the next batch while the main thread runs Python — and fall back
    to NumPy loops otherwise.
    """

    def __init__(self, input_types: Sequence, slot_names: Sequence[str]):
        from paddle_tpu_torch.native import get_lib

        self._native = get_lib()
        if isinstance(input_types, dict):
            self.slot_names = list(input_types.keys())
            self.input_types = [input_types[k] for k in self.slot_names]
        else:
            self.input_types = list(input_types)
            self.slot_names = list(slot_names)
        assert len(self.input_types) == len(self.slot_names), (
            f"provider declares {len(self.input_types)} slots but model has "
            f"input layers {self.slot_names}"
        )

    def assemble(self, samples: List[Sequence[Any]]) -> Dict[str, Argument]:
        # samples are positional lists/tuples or dicts keyed by slot name
        # (both are legal @provider yields, ref PyDataProvider2.py docs)
        out: Dict[str, Argument] = {}
        for i, (name, tp) in enumerate(zip(self.slot_names, self.input_types)):
            values = [s[name] if isinstance(s, dict) else s[i] for s in samples]
            out[name] = self._slot(values, tp)
        return out

    def _slot(self, values: List[Any], tp) -> Argument:
        if tp.seq_type == SequenceType.NO_SEQUENCE:
            return self._scalar_slot(values, tp)
        if tp.seq_type == SequenceType.SEQUENCE:
            return self._seq_slot(values, tp)
        return self._subseq_slot(values, tp)

    # ---- scanners (roles of Dense/Index/Sparse*Scanner in the reference)

    def _dense_row(self, v, tp) -> np.ndarray:
        return np.asarray(v, dtype=np.float32).reshape(tp.dim)

    def _sparse_row(self, v, tp, with_value: bool) -> np.ndarray:
        row = np.zeros((tp.dim,), dtype=np.float32)
        if with_value:
            for idx, val in v:
                row[int(idx)] = float(val)
        else:
            idx = np.asarray(v, dtype=np.int64)
            row[idx] = 1.0
        return row

    def _row(self, v, tp) -> np.ndarray:
        if tp.type == DataType.Dense:
            return self._dense_row(v, tp)
        if tp.type == DataType.SparseNonValue:
            return self._sparse_row(v, tp, with_value=False)
        if tp.type == DataType.SparseValue:
            return self._sparse_row(v, tp, with_value=True)
        raise ValueError(f"unsupported slot type {tp.type}")

    # -- native marshalling helpers

    def _split_sparse(self, rows, tp):
        """Flatten sparse rows → (indices[i64], values[f32]|None, counts[i32])."""
        counts = np.asarray([len(r) for r in rows], dtype=np.int32)
        total = int(counts.sum())
        if tp.type == DataType.SparseValue:
            idx = np.fromiter(
                (int(p[0]) for r in rows for p in r), dtype=np.int64, count=total
            )
            val = np.fromiter(
                (float(p[1]) for r in rows for p in r), dtype=np.float32, count=total
            )
            return idx, val, counts
        idx = np.fromiter(
            (int(i) for r in rows for i in r), dtype=np.int64, count=total
        )
        return idx, None, counts

    @staticmethod
    def _check_bounds(idx: np.ndarray, dim: int) -> None:
        # the C packers don't bounds-check; a bad index must fail here like
        # the NumPy fallback would, not corrupt the batch buffer
        if idx.size and (idx.min() < 0 or idx.max() >= dim):
            bad = idx[(idx < 0) | (idx >= dim)][0]
            raise IndexError(f"sparse index {int(bad)} out of range [0, {dim})")

    def _native_sparse_rows(self, rows, tp) -> np.ndarray:
        lib = self._native
        idx, val, counts = self._split_sparse(rows, tp)
        self._check_bounds(idx, tp.dim)
        out = np.empty((len(rows), tp.dim), dtype=np.float32)
        lib.pt_pack_sparse_rows(
            ptr(idx, ctypes.c_int64),
            ptr(val, ctypes.c_float) if val is not None else None,
            ptr(counts, ctypes.c_int32),
            len(rows),
            tp.dim,
            ptr(out, ctypes.c_float),
        )
        return out

    def _scalar_slot(self, values, tp) -> Argument:
        if tp.type == DataType.Index:
            return _argument(ids=np.asarray(values, dtype=np.int32))
        if self._native is not None and tp.type in (
            DataType.SparseNonValue,
            DataType.SparseValue,
        ):
            return _argument(value=self._native_sparse_rows(values, tp))
        rows = np.stack([self._row(v, tp) for v in values])
        return _argument(value=rows)

    def _seq_slot(self, values, tp) -> Argument:
        B = len(values)
        lengths = np.asarray([len(v) for v in values], dtype=np.int32)
        T = bucket_length(int(lengths.max()) if B else 1)
        lib = self._native
        if tp.type == DataType.Index:
            if lib is not None:
                flat = _flat_i32(values, int(lengths.sum()))
                ids = np.empty((B, T), dtype=np.int32)
                lib.pt_pack_index_seq(
                    ptr(flat, ctypes.c_int32), ptr(lengths, ctypes.c_int32),
                    B, T, ptr(ids, ctypes.c_int32),
                )
                return _argument(ids=ids, seq_lengths=lengths)
            ids = np.zeros((B, T), dtype=np.int32)
            for b, seq in enumerate(values):
                ids[b, : len(seq)] = np.asarray(seq, dtype=np.int32)
            return _argument(ids=ids, seq_lengths=lengths)
        if lib is not None and tp.type == DataType.Dense:
            blocks = [
                np.asarray(seq, dtype=np.float32).reshape(len(seq), tp.dim)
                for seq in values
            ]
            flat = np.concatenate(blocks) if blocks else np.empty((0, tp.dim), np.float32)
            flat = np.ascontiguousarray(flat)
            val = np.empty((B, T, tp.dim), dtype=np.float32)
            lib.pt_pack_dense_seq(
                ptr(flat, ctypes.c_float), ptr(lengths, ctypes.c_int32),
                B, T, tp.dim, ptr(val, ctypes.c_float),
            )
            return _argument(value=val, seq_lengths=lengths)
        if lib is not None and tp.type in (DataType.SparseNonValue, DataType.SparseValue):
            steps = [row for seq in values for row in seq]
            idx, sval, step_counts = self._split_sparse(steps, tp)
            self._check_bounds(idx, tp.dim)
            val = np.empty((B, T, tp.dim), dtype=np.float32)
            lib.pt_pack_sparse_seq(
                ptr(idx, ctypes.c_int64),
                ptr(sval, ctypes.c_float) if sval is not None else None,
                ptr(step_counts, ctypes.c_int32),
                ptr(lengths, ctypes.c_int32),
                B, T, tp.dim, ptr(val, ctypes.c_float),
            )
            return _argument(value=val, seq_lengths=lengths)
        val = np.zeros((B, T, tp.dim), dtype=np.float32)
        for b, seq in enumerate(values):
            for t, item in enumerate(seq):
                val[b, t] = self._row(item, tp)
        return _argument(value=val, seq_lengths=lengths)

    def _subseq_slot(self, values, tp) -> Argument:
        B = len(values)
        num_subs = np.asarray([len(v) for v in values], dtype=np.int32)
        S = max(int(num_subs.max()) if B else 1, 1)
        sub_lens = np.zeros((B, S), dtype=np.int32)
        for b, sample in enumerate(values):
            for s, sub in enumerate(sample):
                sub_lens[b, s] = len(sub)
        T = bucket_length(int(sub_lens.max()))
        if tp.type == DataType.Index:
            if self._native is not None:
                total = int(sub_lens.sum())
                flat = _flat_i32(
                    (sub for sample in values for sub in sample), total
                )
                ids = np.empty((B, S, T), dtype=np.int32)
                self._native.pt_pack_index_subseq(
                    ptr(flat, ctypes.c_int32), ptr(sub_lens, ctypes.c_int32),
                    B, S, T, ptr(ids, ctypes.c_int32),
                )
                return _argument(ids=ids, seq_lengths=num_subs, sub_seq_lengths=sub_lens)
            ids = np.zeros((B, S, T), dtype=np.int32)
            for b, sample in enumerate(values):
                for s, sub in enumerate(sample):
                    ids[b, s, : len(sub)] = np.asarray(sub, dtype=np.int32)
            return _argument(ids=ids, seq_lengths=num_subs, sub_seq_lengths=sub_lens)
        val = np.zeros((B, S, T, tp.dim), dtype=np.float32)
        for b, sample in enumerate(values):
            for s, sub in enumerate(sample):
                for t, item in enumerate(sub):
                    val[b, s, t] = self._row(item, tp)
        return _argument(value=val, seq_lengths=num_subs, sub_seq_lengths=sub_lens)


class MultiDataProvider:
    """Ratio-mixed composition of sub-providers (ref: MultiDataProvider,
    paddle/gserver/dataproviders/MultiDataProvider.h:22):
    each pass draws samples from every sub-provider's stream in proportion
    to its DataConfig.data_ratio, through one shared shuffle/batch path.
    All sub-providers must declare the same slot layout."""

    def __init__(self, subs: List["DataProvider"], ratios: List[int],
                 async_prefetch: bool = True):
        assert subs and len(subs) == len(ratios)
        self.subs = subs
        self.ratios = [max(int(r), 1) for r in ratios]
        self.async_prefetch = async_prefetch
        base = subs[0]
        self.batch_size = base.batch_size
        self.assembler = base.assembler

        def layout(p):
            return [(t.type, t.dim, t.seq_type) for t in p.assembler.input_types]

        for i, sub in enumerate(subs[1:], 1):
            assert layout(sub) == layout(base), (
                f"multi data provider: sub-provider {i} slot layout "
                f"{layout(sub)} != {layout(base)}"
            )
        self._base = base

    def batches(self) -> Iterator[Dict[str, Argument]]:
        # interleave ratio-sized runs from each sub-stream into the base
        # provider's shuffle/batch machinery
        def mixed_samples():
            its = [iter(sub._samples()) for sub in self.subs]
            live = [True] * len(its)
            while any(live):
                for i, it in enumerate(its):
                    if not live[i]:
                        continue
                    for _ in range(self.ratios[i]):
                        try:
                            yield next(it)
                        except StopIteration:
                            live[i] = False
                            break

        if self.async_prefetch:
            yield from self._base._prefetched(
                self._base._batch_lists_from(mixed_samples())
            )
        else:
            yield from self._base._batches_from(mixed_samples())

    def shuffle_state(self):
        return self._base.shuffle_state()

    def set_shuffle_state(self, state) -> None:
        self._base.set_shuffle_state(state)


class DataProvider:
    """Pass-oriented batch iterator over a @provider object.

    getNextBatch analog (paddle/gserver/dataproviders/
    DataProvider.h:313) with shuffle pool and async double-buffering.
    """

    def __init__(
        self,
        provider_obj,
        file_list: List[str],
        batch_size: int,
        slot_names: Sequence[str],
        provider_kwargs: Optional[Dict] = None,
        async_prefetch: bool = True,
        seed: int = 1,
        drop_last: bool = False,
        for_test: bool = False,
        stall_timeout: Optional[float] = None,
        max_bad_samples: Optional[int] = None,
        retry: Optional[RetryPolicy] = None,
        packer_threads: Optional[int] = None,
        prefetch_depth: Optional[int] = None,
    ):
        from paddle_tpu_torch.utils.flags import FLAGS

        self.provider = provider_obj
        self.file_list = file_list
        self.batch_size = batch_size
        # resilience knobs: explicit argument > global flag
        self.stall_timeout = (
            float(FLAGS.data_stall_timeout) if stall_timeout is None else float(stall_timeout)
        )
        self.max_bad_samples = (
            int(FLAGS.max_bad_samples) if max_bad_samples is None else int(max_bad_samples)
        )
        # packing-stage parallelism (doc/performance.md "Zero-stall
        # host"): N pool threads run BatchAssembler.assemble (the native
        # C packers release the GIL) feeding an order-preserving queue
        # of prefetch_depth packed batches; 1 keeps the classic single
        # prefetch thread
        self.packer_threads = max(1, int(
            FLAGS.data_packer_threads if packer_threads is None else packer_threads
        ))
        self.prefetch_depth = max(1, int(
            FLAGS.prefetch_depth if prefetch_depth is None else prefetch_depth
        ))
        self.retry = retry if retry is not None else RetryPolicy.from_flags(FLAGS)
        self._bad_samples = 0
        # sample-granular watchdog heartbeat (see _watched_get): a
        # provider legitimately spending minutes filling a big shuffle
        # pool IS making progress and must not trip the stall timeout
        self._progress = time.monotonic()
        init_kwargs = dict(provider_kwargs or {})
        # runtime-injected hook kwargs (reference PyDataProvider2 contract):
        # user args from the config take precedence if they collide
        init_kwargs.setdefault("is_train", not for_test)
        init_kwargs.setdefault("file_list", list(file_list))
        self.settings = provider_obj.init(**init_kwargs)
        self.assembler = BatchAssembler(self.settings.input_types, slot_names)
        self.async_prefetch = async_prefetch
        self.rng = random.Random(seed)
        self.drop_last = drop_last
        # should_shuffle=None in the provider means: shuffle in training,
        # keep order for test/gen (matches the reference trainer)
        shuffle = self.settings.should_shuffle
        self.shuffle = (not for_test) if shuffle is None else bool(shuffle)
        # length-sorted bucketing (TPU-native @provider extension, see
        # data/provider.py): only ever applied on the shuffled training
        # path — test/generation sample order must never change
        self.sort_by_length = (
            self.shuffle and bool(getattr(self.settings, "sort_by_length", False))
        )
        self._cache: Optional[List] = None
        self._use_cache = getattr(provider_obj, "cache", 0) == 1

    # -- sample stream

    def _samples(self) -> Iterator[Sequence[Any]]:
        if self._use_cache and self._cache is not None:
            yield from self._cache
            return
        collect = [] if self._use_cache else None
        for fname in self.file_list:
            for sample in self._iter_file(fname):
                if not isinstance(sample, (list, tuple, dict)):
                    sample = [sample]
                if self.max_bad_samples > 0 and not self._sample_ok(sample, fname):
                    continue
                if collect is not None:
                    collect.append(sample)
                yield sample
        if collect is not None:
            self._cache = collect

    def _iter_file(self, fname: str) -> Iterator[Any]:
        """One file's samples through the shared RetryPolicy: a transient
        error from the user generator (flaky shared FS, a remote source
        hiccup) re-opens the generator and fast-forwards past the samples
        already yielded. Exactly-once delivery holds for generators that
        yield the same sequence on every open of the same file (true of
        every provider in this repo — shuffling happens downstream in the
        pool); a generator with INTERNAL nondeterministic order may
        duplicate or drop samples across a retry. Fast-forwarding also
        re-runs the generator's side effects from the start of the
        file."""
        yielded = 0
        state = None
        failed_at = -1
        while True:
            it = self.provider.generator_fn(self.settings, fname)
            try:
                skip = yielded
                for sample in it:
                    if skip > 0:
                        skip -= 1
                        # fast-forward IS progress: without a heartbeat a
                        # long replay after a late-file retry would trip
                        # the stall watchdog mid-recovery
                        self._progress = time.monotonic()
                        continue
                    fault_point("provider.yield", info=fname)
                    yield sample
                    yielded += 1
                return
            except self.retry.retry_on as e:
                # the attempt/deadline budget covers one failure BURST:
                # successful progress since the last failure earns a fresh
                # budget, so two isolated hiccups minutes apart on a huge
                # file don't add up to "exhausted"
                if state is None or yielded > failed_at:
                    state = self.retry.begin(f"provider {self.provider.name}({fname})")
                failed_at = yielded
                state.retry(e)  # sleeps, or re-raises when exhausted

    def _sample_ok(self, sample, fname: str) -> bool:
        """Bounded bad-sample budget (``--max_bad_samples``): a sample
        that cannot be assembled is skipped and logged instead of
        poisoning its whole batch, up to the budget — then fail loudly.
        Validation (a one-sample assembly) only runs when the budget is
        enabled, so the default path pays nothing."""
        try:
            self.assembler.assemble([sample])
            return True
        except Exception as e:
            self._bad_samples += 1
            obs.registry().counter("data.bad_samples").inc()
            if self._bad_samples > self.max_bad_samples:
                raise BadSampleError(
                    f"provider {self.provider.name}: {self._bad_samples} malformed "
                    f"samples exceeds --max_bad_samples={self.max_bad_samples} "
                    f"(last, from {fname!r}: {e})"
                ) from e
            if self._bad_samples <= 5 or self._bad_samples % 100 == 0:
                logger.warning(
                    "skipping malformed sample %d/%d from %s: %s",
                    self._bad_samples, self.max_bad_samples, fname, e,
                )
            return False

    def shuffle_state(self):
        """The shuffle's generator state. Taken at a pass's start, it lets
        the pass run again over the same batches in the same order (a
        rollback's replay)."""
        return self.rng.getstate()

    def set_shuffle_state(self, state) -> None:
        self.rng.setstate(state)

    def batches(self) -> Iterator[Dict[str, Argument]]:
        """One pass of batches (shuffled within the pool)."""
        if self.async_prefetch:
            yield from self._prefetched(self._batch_lists_from(self._samples()))
        else:
            yield from self._batches_sync()

    def _prefetched(self, batch_lists) -> Iterator[Dict[str, Argument]]:
        """The async pipeline over a raw batch-list stream — always the
        packer-pool pipeline: with ``packer_threads=1`` a one-worker
        pool IS the classic double-buffer (one thread packs ahead of
        the consumer through a bounded queue), so a single
        implementation carries the order, watchdog, fault-site, and
        telemetry contracts for every thread count."""
        yield from self._pool_packed(batch_lists)

    def _batches_sync(self) -> Iterator[Dict[str, Argument]]:
        yield from self._batches_from(self._samples())

    def _batches_from(self, samples) -> Iterator[Dict[str, Argument]]:
        for batch in self._batch_lists_from(samples):
            yield self.assembler.assemble(batch)

    def _batch_lists_from(self, samples) -> Iterator[List]:
        """The sequential half of batching: shuffle pool, length sort,
        batch slicing — yields raw SAMPLE LISTS so the CPU-heavy
        ``assemble`` can run wherever the caller wants (inline, one
        prefetch thread, or the packer pool)."""
        pool_size = self.settings.pool_size
        if pool_size is None or pool_size <= 0:
            pool_size = 10000 * max(1, self.batch_size // 128 + 1)
        pool: List = []
        for sample in samples:
            self._progress = time.monotonic()  # heartbeat: per SAMPLE
            pool.append(sample)
            if len(pool) >= pool_size:
                yield from self._drain(pool, final=False)
        yield from self._drain(pool, final=True)

    def _sample_len(self, sample) -> int:
        """Padded-cost key for length sorting. SEQUENCE slots cost their
        length; SUB_SEQUENCE slots pad to [S, T] (see _subseq_slot), so
        their key is the padded AREA S·max(sub length) — sorting by
        subsequence count alone would group samples with wildly different
        sub-lengths and deliver no padding reduction."""
        cost = 0
        for i, (name, tp) in enumerate(
            zip(self.assembler.slot_names, self.assembler.input_types)
        ):
            if tp.seq_type == SequenceType.NO_SEQUENCE:
                continue
            v = sample[name] if isinstance(sample, dict) else sample[i]
            if tp.seq_type == SequenceType.SUB_SEQUENCE:
                cost = max(cost, len(v) * max((len(s) for s in v), default=0))
            else:
                cost = max(cost, len(v))
        return cost

    def _drain(self, pool: List, final: bool) -> Iterator[List]:
        """Slice the (shuffled/sorted) pool into raw batch sample lists."""
        if self.shuffle:
            self.rng.shuffle(pool)
        if self.sort_by_length:
            # shuffle-then-stable-sort: similar-length samples become
            # batch neighbors (tight padding), equal-length runs stay
            # randomly ordered, and the BATCH order is re-shuffled below
            # so the pass still visits lengths in random order
            pool.sort(key=self._sample_len)
            batches = []
            while len(pool) >= self.batch_size:
                batches.append(pool[: self.batch_size])
                del pool[: self.batch_size]
            self.rng.shuffle(batches)
            yield from batches
            # the remainder (the longest leftovers) mixes into the next drain
        else:
            # keep a remainder in the pool between drains so shuffling
            # mixes across pool boundaries
            while len(pool) >= self.batch_size:
                batch = pool[: self.batch_size]
                del pool[: self.batch_size]
                yield batch
        if final and pool and not self.drop_last:
            yield list(pool)
            pool.clear()

    def _watched_get(self, fetch, beat: List[float], worker, q, age_gauge) -> Any:
        """One watchdog-guarded wait for a pipeline item.

        ``fetch(timeout_or_None)`` must return the item or raise
        ``queue.Empty`` / ``TimeoutError`` on a bounded wait that came
        up empty. Shared by the pool consumer's two wait points (queue
        get, future result) so the stall-detection rule cannot drift:
        when the consumer has waited ``stall_timeout`` seconds AND
        nothing in the pipeline made progress in that window (not a
        batch handed over — ``beat`` — nor one raw sample pulled —
        ``self._progress``), raise a diagnosable DataStallError instead
        of hanging. 0 disables the watchdog. ``age_gauge`` is resolved
        once by the caller — this runs twice per batch on the consumer
        hot path and must not pay a locked registry lookup each time."""
        timeout = self.stall_timeout
        if not timeout or timeout <= 0:
            return fetch(None)
        wait_start = cc.monotonic()
        while True:
            try:
                return fetch(min(timeout / 4.0, 1.0))
            except (queue.Empty, TimeoutError, _FutureTimeout):
                now = cc.monotonic()
                # progress = a batch handed over (beat) OR a raw sample
                # pulled (self._progress): pool-filling counts as
                # progress, only true dead air trips
                last = max(beat[0], self._progress)
                age_gauge.set(now - last)
                if now - wait_start >= timeout and now - last >= timeout:
                    raise DataStallError(
                        f"data pipeline stalled: no batch for "
                        f"{now - wait_start:.1f}s (stall timeout "
                        f"{timeout:g}s; provider "
                        f"{getattr(self.provider, 'name', '?')}; "
                        f"prefetch worker "
                        f"{'alive' if worker.is_alive() else 'dead'}, "
                        f"last progress {now - last:.1f}s ago, "
                        f"queue depth {q.qsize()}). Raise "
                        f"--data_stall_timeout or fix the provider."
                    )

    def _pool_packed(self, batch_lists: Iterator[List]) -> Iterator[Dict[str, Argument]]:
        """N-thread packing stage (``--data_packer_threads``): a
        dispatcher thread runs the sequential pool/shuffle half and
        submits each raw batch to a thread pool whose workers run
        ``BatchAssembler.assemble`` (the native C packers release the
        GIL, so packs genuinely overlap); completed batches flow to the
        consumer through an order-preserving queue bounded at
        ``--prefetch_depth``. With one packer this IS the classic
        DoubleBuffer analog: one thread packs ahead of the consumer
        through a bounded queue. A provider that blocks forever (dead
        NFS mount, a generator stuck on a socket) used to hang the
        training loop inside ``q.get()`` — which also blocked SIGTERM
        preemption handling, the worst possible failure on a pod; the
        consumer polls via ``_watched_get`` and raises a diagnosable
        DataStallError (worker liveness, queue depth, stall age)
        instead. The ``provider.stall`` fault site and bad-sample
        budget (upstream in ``_samples``) keep their old semantics."""
        from concurrent.futures import ThreadPoolExecutor

        q = cc.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        err: List[BaseException] = []
        beat = [cc.monotonic()]
        busy = [0]
        busy_lock = cc.Lock()
        busy_hist = obs.registry().histogram("data.pack_threads_busy")

        def pack(batch):
            with busy_lock:
                busy[0] += 1
                n_busy = busy[0]
            try:
                busy_hist.observe(float(n_busy))
                out = self.assembler.assemble(batch)
                beat[0] = cc.monotonic()  # a finished pack IS progress
                return out
            finally:
                with busy_lock:
                    busy[0] -= 1

        pool = ThreadPoolExecutor(
            max_workers=self.packer_threads, thread_name_prefix="pt-data-pack"
        )

        def dispatcher():
            try:
                for batch in batch_lists:
                    fault_point("provider.stall")
                    beat[0] = cc.monotonic()
                    # the bounded put is the backpressure: at most
                    # prefetch_depth packed/packing batches run ahead
                    q.put(pool.submit(pack, batch))
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = cc.Thread(
            target=dispatcher, daemon=True, name="pt-data-prefetch"
        )
        t.start()
        wait_counter = obs.registry().counter("data.prefetch_wait_s")
        age_gauge = obs.registry().gauge("data.heartbeat_age_s")

        def fetch_future(to):
            return q.get(timeout=to) if to is not None else q.get()

        try:
            while True:
                wait_t0 = time.perf_counter()
                fut = self._watched_get(fetch_future, beat, t, q, age_gauge)
                if fut is not sentinel:
                    # the future is already executing (pool order =
                    # submission order), so this wait is short — but a
                    # packer wedged inside a bad native call must still
                    # trip the watchdog, not hang the step loop
                    item = self._watched_get(
                        lambda to: fut.result(timeout=to), beat, t, q,
                        age_gauge,
                    )
                else:
                    item = sentinel
                waited = time.perf_counter() - wait_t0
                wait_counter.inc(waited)
                age_gauge.set(0.0)
                if waited > 1e-3:
                    obs_spans.record_perf("data/prefetch_wait", wait_t0, waited)
                if item is sentinel:
                    break
                yield item
            if err:
                raise err[0]
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def create_data_provider(
    data_config: DataConfig,
    batch_size: int,
    slot_names: Sequence[str],
    async_prefetch: bool = True,
    seed: int = 1,
    for_test: bool = False,
    stall_timeout: Optional[float] = None,
    max_bad_samples: Optional[int] = None,
    retry: Optional[RetryPolicy] = None,
    packer_threads: Optional[int] = None,
    prefetch_depth: Optional[int] = None,
) -> DataProvider:
    """Instantiate from a DataConfig (define_py_data_sources2 output).

    ``stall_timeout`` / ``max_bad_samples`` / ``retry`` override the
    global flags (--data_stall_timeout / --max_bad_samples /
    --io_retry_*) for this provider; ``packer_threads`` /
    ``prefetch_depth`` override --data_packer_threads /
    --prefetch_depth. None inherits the flag."""
    import importlib
    import os

    resilience_kw = dict(
        stall_timeout=stall_timeout, max_bad_samples=max_bad_samples, retry=retry,
        packer_threads=packer_threads, prefetch_depth=prefetch_depth,
    )
    if data_config.type == "multi":
        subs = [
            create_data_provider(
                sub, batch_size, slot_names,
                async_prefetch=False, seed=seed + i, for_test=for_test,
                **resilience_kw,
            )
            for i, sub in enumerate(data_config.sub_data_configs)
        ]
        return MultiDataProvider(
            subs,
            [s.data_ratio for s in data_config.sub_data_configs],
            async_prefetch=async_prefetch,
        )
    with open(data_config.files) as f:
        file_list = [line.strip() for line in f if line.strip()]
    if data_config.type == "bin":
        # binary shards (ProtoDataProvider role, paddle_tpu_torch.data.binary)
        from paddle_tpu_torch.data.binary import BinaryProvider

        assert file_list, f"{data_config.files}: empty shard list"
        return DataProvider(
            BinaryProvider(file_list[0]),
            file_list,
            batch_size,
            slot_names,
            async_prefetch=async_prefetch,
            seed=seed,
            for_test=for_test,
            **resilience_kw,
        )
    assert data_config.type in ("py2", "py"), f"unsupported data type {data_config.type!r}"
    # the provider module conventionally sits next to the config / file
    # list (reference: PyDataProvider2.cpp loads the module by name with
    # the config dir importable); make cwd + the list dir importable.
    # Under the port's paddle shim: the module and its neighbours load
    # fresh, bound to the port, and leave no copy behind (paddle_shim).
    with paddle_shim(os.path.dirname(os.path.abspath(data_config.files)), os.getcwd()):
        module = importlib.import_module(data_config.load_data_module)
    provider_obj = getattr(module, data_config.load_data_object)
    kwargs = json.loads(data_config.load_data_args) if data_config.load_data_args else {}
    return DataProvider(
        provider_obj,
        file_list,
        batch_size,
        slot_names,
        provider_kwargs=kwargs,
        async_prefetch=async_prefetch,
        seed=seed,
        for_test=for_test,
        **resilience_kw,
    )
