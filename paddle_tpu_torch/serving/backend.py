"""Decode-backend seam for the continuous-batching engine.

The engine (engine.py) is jax-free and schedules *slots*; everything
device-shaped hides behind this protocol:

- ``slots`` / ``max_length`` — capacity and the decode-step bound.
- ``decode_blocks`` — the pre-warmed decode-block ladder (micro-steps
  per launch the engine's :func:`~paddle_tpu_torch.serving.engine.pick_block`
  policy may choose from).
- ``admit(slot_ids, requests, budgets)`` — prefill: write the named
  requests' decode state into the named slots (overwriting whatever a
  previous occupant left there — eviction needs no separate call).
- ``dispatch(block=None)`` — enqueue ONE decode launch advancing every
  slot by ``block`` micro-steps, without waiting for its results (the
  pipelined loop's first half); ``collect() -> StepOut`` — gather the
  OLDEST in-flight launch's results (blocking); ``inflight`` — how many
  launches are dispatched-but-uncollected.
- ``spec_blocks`` — the pre-warmed speculation ladder (draft lengths K
  the engine's ``pick_spec_k`` policy may choose from); empty = the
  backend takes no drafts. When non-empty, ``dispatch``/``step`` accept
  ``draft={slot: [tokens...]}``: ONE verify launch scores every drafted
  position, commits the longest matching prefix per slot and, on the
  first mismatch, the model's corrected token rides free. Slots without
  a draft (or whose draft misses immediately) advance exactly one plain
  greedy step — exact greedy output is preserved unconditionally.
- ``step(block=None) -> StepOut`` — dispatch + collect in one call (the
  blocking loop and one-shot callers).
- ``warmup()`` — pay compiles before serving (so compile telemetry
  shows recompiles=0 afterwards); ``reset()`` — discard all device
  state AND the in-flight queue after a failed launch (the engine
  errors every in-flight cohort and keeps serving).
- ``reload(params)`` — hot weight swap, called by the engine ONLY at
  an iteration boundary (between a collect and the next dispatch): an
  O(1) reference replacement of the weights the next launch reads.
  Same shapes → no recompile; already-dispatched launches snapshotted
  the old reference and are unaffected.

:class:`FakeBackend` is the deterministic jax-free implementation the
unit tests and ``tests/race_specs/spec_serve_engine.py`` drive the REAL
engine with. It models the in-flight pipeline faithfully: ``dispatch``
advances the scripted rows immediately but parks the ``StepOut`` (or
the injected fault) in a FIFO that only ``collect`` drains — matching
jax async dispatch, where results AND errors surface at readback.
:class:`~paddle_tpu_torch.serving.jax_backend.JaxDecodeBackend` is the
production implementation.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from paddle_tpu_torch.utils import concurrency as cc

# A draft batch: slot index -> proposed next tokens (host ints). The
# engine builds it under its lock from the DraftTable; the backend
# snapshots it at dispatch (the pipelined loop carries it alongside the
# slot->request cohort snapshot).
DraftBatch = Dict[int, List[int]]


def parse_decode_blocks(spec: Union[int, str, Sequence[int], None]) -> Tuple[int, ...]:
    """The decode-block ladder from its flag/env spelling: an int, an
    int sequence, or a comma list like ``"1,2,4,8"`` — sorted, deduped,
    every rung >= 1. The single-int form is the PR-12 flag unchanged (a
    one-rung ladder)."""
    if spec is None:
        return (1,)
    if isinstance(spec, str):
        parts = [p for p in spec.replace(" ", "").split(",") if p]
        blocks = [int(p) for p in parts] or [1]
    elif isinstance(spec, (list, tuple)):
        blocks = [int(u) for u in spec] or [1]
    else:
        blocks = [int(spec)]
    out = tuple(sorted({max(u, 1) for u in blocks}))
    return out or (1,)


def parse_spec_tokens(spec: Union[int, str, Sequence[int], None]) -> Tuple[int, ...]:
    """The speculation ladder (draft lengths K) from its flag/env
    spelling. Same grammar as :func:`parse_decode_blocks` except that
    ``None``/``0``/``"0"``/``""`` mean *speculation off* — an empty
    ladder — and rungs < 1 are dropped rather than clamped."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        parts = [p for p in spec.replace(" ", "").split(",") if p]
        ks = [int(p) for p in parts]
    elif isinstance(spec, (list, tuple)):
        ks = [int(k) for k in spec]
    else:
        ks = [int(spec)]
    return tuple(sorted({k for k in ks if k >= 1}))


SLOT_DTYPES = ("f32", "bf16")


def parse_slot_dtype(name: Union[str, None]) -> str:
    """Validate a ``--serve_slot_dtype`` spelling. ``f32`` is the
    PR-12 behavior unchanged; ``bf16`` stores slot state (GRU carries +
    captured statics) in bfloat16 while every step still accumulates in
    f32 — see graph/decode_step.plan_fused_step's mixed-precision
    plan."""
    dt = (name or "f32").strip().lower()
    if dt not in SLOT_DTYPES:
        raise ValueError(
            f"serve_slot_dtype must be one of {SLOT_DTYPES}, got {name!r}")
    return dt


@dataclasses.dataclass
class StepOut:
    """One iteration's device readback.

    ``tokens [u, B]`` int — the block's emitted tokens per slot;
    ``live [u, B]`` bool — whether the slot was still generating at that
    micro-step (False rows are frozen padding, not output);
    ``finished [B]`` bool — slot hit EOS or its token budget and is free
    for re-admission."""

    tokens: np.ndarray
    live: np.ndarray
    finished: np.ndarray


class FakeBackend:
    """Deterministic, jax-free decode backend.

    ``token_fn(rid, step_index)`` scripts the "model": it returns the
    token the request emits at its ``step_index``-th decode step
    (default: a stable hash — never EOS, so budgets do the finishing).
    ``chunk`` mirrors the jax backend's decode-block ladder (an int or
    a ladder spec). ``step_delay_s`` burns (virtual, under the race
    shim) clock per launch at dispatch — where the modeled device does
    its work. ``fail_at_launch`` makes the named dispatched launch(es)
    fault — an int or a collection of launch ordinals (consecutive
    faults are what the circuit breaker counts); like the real backend,
    the fault surfaces at ``collect()`` (the chaos seam for the
    engine's error path, pipelined included). ``fail_with`` overrides
    the injected exception — e.g. a RESOURCE_EXHAUSTED-marked error to
    drive the engine's OOM shutdown path."""

    def __init__(self, slots: int = 4, max_length: int = 8, eos: int = 1,
                 token_fn: Optional[Callable[[str, int], int]] = None,
                 chunk: Union[int, str, Sequence[int]] = 1,
                 step_delay_s: float = 0.0,
                 fail_at_launch: Union[int, Sequence[int], None] = None,
                 fail_with: Optional[Callable[[int], Exception]] = None,
                 spec_tokens: Union[int, str, Sequence[int], None] = None):
        self.slots = int(slots)
        self.max_length = int(max_length)
        self.eos = int(eos)
        self.decode_blocks = parse_decode_blocks(chunk)
        self.chunk = self.decode_blocks[-1]
        self.spec_blocks = parse_spec_tokens(spec_tokens)
        self.step_delay_s = float(step_delay_s)
        if fail_at_launch is None:
            self.fail_at_launch = frozenset()
        elif isinstance(fail_at_launch, int):
            self.fail_at_launch = frozenset((fail_at_launch,))
        else:
            self.fail_at_launch = frozenset(int(n) for n in fail_at_launch)
        self.fail_with = fail_with
        self.token_fn = token_fn or (
            lambda rid, i: 2 + (hash((rid, i)) % 97)
        )
        self.launches = 0
        self.reloads = 0                    # reload() calls, for tests
        self.admits: List[List[str]] = []   # admission waves, for tests
        self.verify_launches = 0            # draft-carrying launches
        self.spec_drafts: List[DraftBatch] = []  # verify inputs, for tests
        self._rows: List[Optional[dict]] = [None] * self.slots
        # dispatched-but-uncollected results (or faults): StepOut |
        # Exception, drained FIFO by collect()
        self._pending: collections.deque = collections.deque()

    # ------------------------------------------------------------ seam

    @property
    def inflight(self) -> int:
        return len(self._pending)

    def warmup(self) -> None:
        pass

    def reset(self) -> None:
        self._rows = [None] * self.slots
        self._pending.clear()

    def reload(self, params: Any) -> None:
        """Hot weight swap, modeled: a callable payload replaces
        ``token_fn`` (the fake's "weights" — tests observe the scripted
        output change at exactly the next launch); anything else just
        counts. Raising here must leave the old behavior serving —
        engine._apply_reload_locked's contract."""
        if callable(params):
            self.token_fn = params
        self.reloads += 1

    def admit(self, slot_ids: Sequence[int], requests: Sequence[Any],
              budgets: Sequence[int]) -> None:
        self.admits.append([r.rid for r in requests])
        for b, req, budget in zip(slot_ids, requests, budgets):
            self._rows[b] = {
                "rid": req.rid,
                "budget": min(int(budget), self.max_length),
                "emitted": 0,
                "done": int(budget) <= 0,
            }

    def dispatch(self, block: Optional[int] = None,
                 draft: Optional[DraftBatch] = None) -> None:
        """Advance the scripted rows now, surface the results (or the
        injected fault) only at collect — the jax async-dispatch
        contract the pipelined engine is written against. With
        ``draft``, the launch is a verify: each slot advances through
        its drafted tokens while the script agrees, plus the corrected
        token on the first disagreement (slots without a draft take one
        plain step)."""
        self.launches += 1
        if self.launches in self.fail_at_launch:
            if self.fail_with is not None:
                self._pending.append(self.fail_with(self.launches))
            else:
                self._pending.append(RuntimeError(
                    f"injected decode fault at launch {self.launches}"))
            return
        if self.step_delay_s:
            cc.sleep(self.step_delay_s)
        if draft:
            self.verify_launches += 1
            snap = {int(b): [int(t) for t in toks]
                    for b, toks in draft.items()}
            self.spec_drafts.append(snap)
            self._pending.append(self._verify(snap))
            return
        u = max(int(block), 1) if block else self.chunk
        B = self.slots
        tokens = np.zeros((u, B), np.int64)
        live = np.zeros((u, B), bool)
        finished = np.zeros((B,), bool)
        for b, row in enumerate(self._rows):
            if row is None:
                continue
            for i in range(u):
                if row["done"]:
                    break
                tok = int(self.token_fn(row["rid"], row["emitted"]))
                tokens[i, b] = tok
                live[i, b] = True
                row["emitted"] += 1
                if tok == self.eos or row["emitted"] >= row["budget"]:
                    row["done"] = True
            finished[b] = row["done"]
        self._pending.append(StepOut(tokens=tokens, live=live,
                                     finished=finished))

    def _verify(self, draft: DraftBatch) -> StepOut:
        """The scripted verify launch: exact greedy semantics — every
        emitted token is ``token_fn``'s own output; the draft only
        decides how many steps a slot gets this launch."""
        u = max(max((len(t) for t in draft.values()), default=0), 1)
        B = self.slots
        tokens = np.zeros((u, B), np.int64)
        live = np.zeros((u, B), bool)
        finished = np.zeros((B,), bool)
        for b, row in enumerate(self._rows):
            if row is None:
                continue
            d = draft.get(b, [])
            i = 0
            while not row["done"]:
                tok = int(self.token_fn(row["rid"], row["emitted"]))
                tokens[i, b] = tok
                live[i, b] = True
                row["emitted"] += 1
                if tok == self.eos or row["emitted"] >= row["budget"]:
                    row["done"] = True
                matched = i < len(d) and tok == d[i]
                i += 1
                if not matched or i >= max(len(d), 1):
                    break
            finished[b] = row["done"]
        return StepOut(tokens=tokens, live=live, finished=finished)

    def collect(self) -> StepOut:
        assert self._pending, "collect() with no launch in flight"
        out = self._pending.popleft()
        if isinstance(out, Exception):
            raise out
        return out

    def step(self, block: Optional[int] = None,
             draft: Optional[DraftBatch] = None) -> StepOut:
        # forward `draft` only when speculating: subclasses that
        # override dispatch(block=...) without the draft seam (every
        # pre-speculation backend shim) keep working un-speculated
        if draft is None:
            self.dispatch(block=block)
        else:
            self.dispatch(block=block, draft=draft)
        return self.collect()
