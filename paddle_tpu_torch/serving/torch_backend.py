"""The PyTorch decode backend: slot state on the card, eager decode launches
dispatched and collected as two halves so the host can run ahead.

Device state is a set of fixed-shape ``[slots, ...]`` tensors — the
captured static-link conditioning (seqToseq: encoder projection and values
per slot), the decoder memory carries, the previous token, per-slot step
counts, done flags and token budgets:

- ``admit`` runs the prefill: the graph forward in gen-capture mode over
  a [slots, T] batch holding the admitted prompts (the encoder GRUs launch
  the GRU kernel), then ``index_copy_`` of each captured row into its
  slot. Rows with the sentinel slot index (``slots``) drop.
- ``dispatch`` runs ``u`` greedy micro-steps eagerly on the current
  stream (with ``fused_step``, one attention-GRU kernel launch each),
  then starts ``non_blocking`` copies of the tokens, live and finished
  flags into pinned host tensors and records a ``torch.cuda.Event``;
  ``collect`` synchronises the oldest in-flight event. Nothing else in
  the loop waits for the card, so launch N+1 is enqueued while N runs.
- ``dispatch(draft=...)`` runs the speculative verify launch instead
  (``spec_tokens``): up to ``k`` micro-steps in which a slot stays live
  only while its drafted token equals the model's own greedy token; the
  first step that differs commits the model's token and freezes the
  slot for the rest of the launch. Every emitted token is the model's
  greedy token, so the streams equal plain decode's.

With ``slot_dtype="bf16"`` the float slot tensors (captured statics and
carries) are stored in bfloat16 and every step computes in float32: the
statics are upcast once a launch, the carries upcast before and rounded
back (to nearest even) after every micro-step, and the prefill's
``index_copy_`` rounds what it admits. Rounding at every micro-step keeps
the streams equal across decode-block rungs.

Finished (or never-admitted) slots are frozen by their flag and emit eos;
the next admission overwrites a slot wholesale. The engine calls the
backend from its scheduler thread, so every tensor names its device
explicitly and all work goes to that device's current stream.
"""

from __future__ import annotations

import collections
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.graph.argument import make_seq
from paddle_tpu_torch.graph.decode_step import (
    capture_prefill,
    make_greedy_step,
    plan_fused_step,
    plan_of,
    plan_slot_dtype,
)
from paddle_tpu_torch.serving.backend import (
    StepOut,
    parse_decode_blocks,
    parse_slot_dtype,
    parse_spec_tokens,
)
from paddle_tpu_torch.utils import concurrency as cc


class UnsupportedModelError(RuntimeError):
    """The generation graph cannot be slot-decoded (see plan_of gates)."""


class TorchDecodeBackend:
    def __init__(self, machine, params, slots: int, prompt_tokens: int,
                 max_length: Optional[int] = None,
                 decode_block: Union[int, str, Sequence[int]] = 1,
                 feed_name: Optional[str] = None,
                 pipeline: bool = True, fused_step: bool = False,
                 spec_tokens: Union[int, str, Sequence[int], None] = None,
                 slot_dtype: str = "f32"):
        plan, reason = plan_of(machine)
        if plan is None:
            raise UnsupportedModelError(reason)
        self.slot_dtype = parse_slot_dtype(slot_dtype)
        slot_plan, why = plan_slot_dtype(self.slot_dtype)
        if slot_plan is None:
            raise UnsupportedModelError(why)
        self._store_dtype = (getattr(torch, slot_plan["store_dtype"])
                             if slot_plan["store_dtype"] else None)
        self.parity_tol = float(slot_plan["parity_tol"])
        self._plan = plan
        self._machine = machine
        self.device = machine.device
        self.params = params
        self.slots = int(slots)
        self.prompt_tokens = int(prompt_tokens)
        self.max_length = min(int(max_length or plan.max_length), plan.max_length)
        self.decode_blocks = parse_decode_blocks(decode_block)
        self.max_block = self.decode_blocks[-1]
        self.spec_blocks = parse_spec_tokens(spec_tokens)
        self.max_spec = self.spec_blocks[-1] if self.spec_blocks else 0
        self.pipeline = bool(pipeline)
        self.serving = False
        self.last_readback_s = 0.0
        # launches of this backend, for run reports: prefills, decode
        # micro-steps (verify micro-steps among them) and verify launches
        # (kernel launches are counted by the kernel wrappers)
        self.prefill_launches = 0
        self.decode_microsteps = 0
        self.verify_launches = 0
        self._warmed = False
        names = list(machine.network.input_layer_names)
        if feed_name is None:
            if len(names) != 1:
                raise UnsupportedModelError(
                    f"model has {len(names)} input layers {names} — pass "
                    "feed_name to choose the prompt sequence input")
            feed_name = names[0]
        self._feed_name = feed_name
        fused_plan = None
        if fused_step:
            fused_plan, why = plan_fused_step(machine, plan, slot_dtype=self.slot_dtype)
            if fused_plan is None:
                raise UnsupportedModelError(
                    f"fused_step: {why} (the unfused per-step decoder still "
                    "serves this model)")
        self.fused_step = fused_plan is not None
        self._step = make_greedy_step(machine, plan, fused_plan=fused_plan)
        self._state = self._fresh_state()
        # dispatched-but-uncollected launches: (host tokens, host lives,
        # host finished, done event or None, block)
        self._inflight: collections.deque = collections.deque()

    # ------------------------------------------------------------ prefill

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor through pinned memory, so the copy
        joins the stream instead of waiting for the launches in flight."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _capture(self, ids: np.ndarray, lens: np.ndarray):
        feed = {self._feed_name: make_seq(None, self._upload(lens),
                                          ids=self._upload(ids))}
        return capture_prefill(self._machine, self._plan, self.params, feed)

    def _fresh_state(self):
        """Zeroed slot buffers, every slot finished (frozen). Shapes come
        from a capture of one dummy prompt; float buffers take the slot
        storage dtype."""
        S, T, dev = self.slots, self.prompt_tokens, self.device
        statics, boots = self._capture(np.zeros((1, T), np.int32), np.ones((1,), np.int32))

        def zeros(t):
            dt = t.dtype
            if self._store_dtype is not None and dt.is_floating_point:
                dt = self._store_dtype
            return torch.zeros((S,) + tuple(t.shape[1:]), dtype=dt, device=dev)

        return {
            "statics": {n: {f: zeros(t) for f, t in d.items()} for n, d in statics.items()},
            "carries": tuple(zeros(b) for b in boots),
            "prev_tok": torch.full((S,), self._plan.bos, dtype=torch.int64, device=dev),
            "finished": torch.ones((S,), dtype=torch.bool, device=dev),
            "steps": torch.zeros((S,), dtype=torch.int32, device=dev),
            "budget": torch.zeros((S,), dtype=torch.int32, device=dev),
        }

    def _prefill_write(self, ids, lens, slot_idx, budgets) -> None:
        """Capture forward over the admitted prompts, then scatter each row
        into its slot; rows whose index is the sentinel ``slots`` drop."""
        S = self.slots
        statics, boots = self._capture(ids, lens)
        self.prefill_launches += 1
        keep = np.flatnonzero(slot_idx < S)
        if keep.size == 0:
            return
        rows = self._upload(keep.astype(np.int64))
        idx = self._upload(slot_idx[keep].astype(np.int64))
        st = self._state

        def put(dst: torch.Tensor, src: torch.Tensor) -> None:
            dst.index_copy_(0, idx, src.index_select(0, rows).to(dst.dtype))

        for name, fields in st["statics"].items():
            for f, dst in fields.items():
                put(dst, statics[name][f])
        for dst, boot in zip(st["carries"], boots):
            put(dst, boot)
        st["prev_tok"].index_fill_(0, idx, self._plan.bos)
        st["finished"].index_fill_(0, idx, False)
        st["steps"].index_fill_(0, idx, 0)
        put(st["budget"], self._upload(budgets.astype(np.int32)))

    # --------------------------------------- reduced-precision slot state
    # Under bf16 the three helpers convert between the stored dtype and
    # float32; under f32 each is the identity.

    def _statics_compute(self, statics):
        if self._store_dtype is None:
            return statics
        up = lambda t: t.float() if t.dtype == self._store_dtype else t
        return {n: {f: up(t) for f, t in d.items()} for n, d in statics.items()}

    def _carries_compute(self, carries):
        if self._store_dtype is None:
            return carries
        return tuple(c.float() if c.dtype == self._store_dtype else c for c in carries)

    def _carries_store(self, like, carries):
        if self._store_dtype is None:
            return carries
        return tuple(c.to(o.dtype) if c.dtype != o.dtype else c
                     for o, c in zip(like, carries))

    def slot_state_bytes(self) -> int:
        """Stored decode-state bytes per slot: captured statics, carries and
        the scalar rows. bf16 storage roughly halves it."""
        st = self._state
        tensors = ([t for d in st["statics"].values() for t in d.values()]
                   + list(st["carries"])
                   + [st[k] for k in ("prev_tok", "finished", "steps", "budget")])
        return sum(t.numel() * t.element_size() for t in tensors) // self.slots

    # ------------------------------------------------------------- decode

    def _decode(self, u: int):
        """``u`` greedy micro-steps over all slots; EOS and budget end a row."""
        st = self._state
        S, um = self.slots, self.max_block
        toks = torch.zeros((um, S), dtype=torch.int64, device=self.device)
        lives = torch.zeros((um, S), dtype=torch.bool, device=self.device)
        carries, prev, fin, steps = st["carries"], st["prev_tok"], st["finished"], st["steps"]
        with torch.no_grad():
            statics = self._statics_compute(st["statics"])
            for i in range(min(u, um)):
                live = ~fin
                cf, prev, fin = self._step(self.params, statics,
                                           self._carries_compute(carries), prev, fin)
                carries = self._carries_store(carries, cf)
                steps = steps + live.to(torch.int32)
                fin = fin | (steps >= st["budget"])
                toks[i] = prev
                lives[i] = live
        self.decode_microsteps += min(u, um)
        st.update(carries=carries, prev_tok=prev, finished=fin, steps=steps)
        return toks, lives, fin

    def _verify(self, draft: torch.Tensor, dlen: torch.Tensor, k: int):
        """The speculative verify launch: up to ``k`` greedy micro-steps,
        where a slot stays live only while its drafted token equals the
        model's own argmax. The first step that differs emits the model's
        token, then the slot is frozen for the rest of the launch.

        ``draft [K, S]`` and ``dlen [S]`` (0: no proposal, the slot takes
        exactly one plain step). A dead row (finished, or its draft
        diverged) still goes through the step, frozen, and emits eos; so
        the last token each slot truly committed is tracked apart from the
        step's feed and becomes ``prev_tok``."""
        st = self._state
        S, km = self.slots, self.max_spec
        dev, eos = self.device, self._plan.eos
        toks = torch.zeros((km, S), dtype=torch.int64, device=dev)
        lives = torch.zeros((km, S), dtype=torch.bool, device=dev)
        carries, prev, fin, steps = st["carries"], st["prev_tok"], st["finished"], st["steps"]
        committed = prev
        accepting = torch.ones((S,), dtype=torch.bool, device=dev)
        n = min(max(int(k), 1), km)
        with torch.no_grad():
            statics = self._statics_compute(st["statics"])
            for i in range(n):
                dead = fin | ~accepting
                live = ~dead
                cf, prev, _ = self._step(self.params, statics,
                                         self._carries_compute(carries), prev, dead)
                carries = self._carries_store(carries, cf)
                steps = steps + live.to(torch.int32)
                # only live rows end a stream: eos or the budget
                fin = fin | (live & (prev == eos)) | (steps >= st["budget"])
                committed = torch.where(live, prev, committed)
                accepting = live & (i < dlen) & (prev == draft[i])
                toks[i] = prev
                lives[i] = live
        self.decode_microsteps += n
        self.verify_launches += 1
        st.update(carries=carries, prev_tok=committed, finished=fin, steps=steps)
        return toks, lives, fin

    # --------------------------------------------------------------- seam

    def warmup(self) -> None:
        """Build the kernels and run every path once before serving: a
        full-width prefill whose rows all drop (sentinel indices), one
        decode launch per ladder rung and one verify launch per
        speculation rung over the all-finished state — zero slot
        effects."""
        if not self._warmed:
            self.serving = False
            S, T = self.slots, self.prompt_tokens
            self._admit_call(np.zeros((S, T), np.int32), np.ones((S,), np.int32),
                             np.full((S,), S, np.int64), np.zeros((S,), np.int32))
            for u in self.decode_blocks:
                self.step(block=u)
            for kk in self.spec_blocks:
                self.step(draft={0: [0] * kk})
            self._warmed = True
        self.serving = True

    def reset(self) -> None:
        self._state = self._fresh_state()
        self._inflight.clear()

    def reload(self, params: Any) -> None:
        """Hot weight swap at an iteration boundary: launches already on
        the stream read the old tensors, the next dispatch the new ones."""
        self.params = params

    def admit(self, slot_ids: Sequence[int], requests: Sequence[Any],
              budgets: Sequence[int]) -> None:
        """The prefill over a [slots, T] admission batch whatever the number
        admitted, as the JAX package's one prefill signature: rows past the
        admitted carry the sentinel and drop. One shape keeps each row's
        captured state bit-equal however the requests were grouped (a
        product's algorithm may change with its row count), which greedy
        parity across admission patterns needs: speculation changes the
        iteration boundaries and with them the groupings."""
        S, T = self.slots, self.prompt_tokens
        ids = np.zeros((S, T), np.int32)
        lens = np.ones((S,), np.int32)
        idx = np.full((S,), S, np.int64)      # sentinel: the row writes nothing
        budg = np.zeros((S,), np.int32)
        for j, (slot, req) in enumerate(zip(slot_ids, requests)):
            p = np.asarray(list(req.prompt or ()), np.int32)[:T]
            ids[j, : p.size] = p
            lens[j] = max(int(p.size), 1)
            idx[j] = int(slot)
            budg[j] = min(int(budgets[j]), self.max_length)
        self._admit_call(ids, lens, idx, budg)

    def _admit_call(self, ids, lens, idx, budg) -> None:
        self._prefill_write(ids, lens, idx, budg)
        if not self.pipeline and self.device.type == "cuda":
            # the serial loop: admission waits for the prefill
            torch.cuda.current_stream(self.device).synchronize()

    def dispatch(self, block: Optional[int] = None, draft=None) -> None:
        """Enqueue one decode launch of ``block`` micro-steps and start the
        device->host copies of its outputs — no waiting. With ``draft``
        (slot -> proposed tokens) the launch is the verify launch."""
        if draft:
            if not self.max_spec:
                raise RuntimeError("draft dispatch on a backend with no "
                                   "speculation ladder (spec_tokens unset)")
            km, S = self.max_spec, self.slots
            d = np.zeros((km, S), np.int64)
            dl = np.zeros((S,), np.int64)
            for b, proposed in draft.items():
                t = [int(x) for x in proposed][:km]
                if t:
                    dl[int(b)] = len(t)
                    d[:len(t), int(b)] = t
            u = max(int(dl.max()), 1)
            toks, lives, fin = self._verify(self._upload(d), self._upload(dl), u)
        else:
            u = int(block) if block else self.max_block
            toks, lives, fin = self._decode(u)
        if self.device.type != "cuda":
            self._inflight.append((toks, lives, fin.clone(), None, u))
            return
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (toks, lives, fin)]
        for h, t in zip(host, (toks, lives, fin)):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._inflight.append((*host, done, u))

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def collect(self) -> StepOut:
        """Gather the oldest in-flight launch (the one wait of the loop)."""
        if not self._inflight:
            raise RuntimeError("collect() with no launch in flight "
                               "(dispatch/collect pairing broken)")
        toks, lives, fin, done, u = self._inflight.popleft()
        t0 = cc.perf_counter()
        if done is not None:
            done.synchronize()
        self.last_readback_s = cc.perf_counter() - t0
        return StepOut(tokens=toks[:u].numpy(), live=lives[:u].numpy(),
                       finished=fin.numpy())

    def step(self, block: Optional[int] = None, draft=None) -> StepOut:
        self.dispatch(block=block, draft=draft)
        return self.collect()
