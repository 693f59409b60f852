"""Host-side draft source for self-speculative decode (PR 20).

Speculative decoding (Leviathan et al. 2023) needs a cheap proposal
distribution. We do not run a second model: the serving workload itself
is the draft source. A seeded n-gram table — bigram and trigram chains
over the *generated* token streams, maintained on the host and updated
only at collect boundaries under the engine lock — proposes up to K
next tokens per slot. The device-side ``serve_verify`` launch then
scores every proposed position with the real model and commits the
longest matching prefix (plus, on a mismatch, the model's corrected
token, which rides free). Exact greedy output is preserved no matter
how bad the drafts are; draft quality only moves throughput.

Design notes:

- jax-free, like the rest of the engine seam. The table is plain dicts
  of ints; ``propose`` walks the chains greedily (most-frequent
  successor, trigram first, bigram backoff) so proposals are
  deterministic for a given observation history — golden-parity tests
  rely on runs being reproducible, and the engine serializes all
  observe/propose calls under its lock.
- ``observe(tokens, context=...)`` counts transitions *into* ``tokens``
  only; the caller passes the previously committed tail as ``context``
  so chains span collect boundaries without double-counting pairs that
  were already observed.
- Ties break toward the smallest token id (stable across dict insert
  order via explicit comparison), salted by ``seed`` only in the sense
  that the seed participates in nothing stochastic — it is kept so a
  future sampled draft policy has a home and so benches can stamp it.
- Bounded: per-context successor maps are capped (``max_successors``)
  and the table evicts the oldest contexts beyond ``max_contexts`` —
  the serving fleet runs for days; the draft table must not be a leak.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["DraftTable"]

# Longest context the chains key on (trigram = 2 tokens of context).
ORDER = 2


class DraftTable:
    """Seeded n-gram/suffix table proposing up to K next tokens.

    The table is shared across slots (requests with similar outputs feed
    each other's drafts — the high-acceptance regime for translation
    serving where decode streams repeat domain phrases) while staying
    correct for adversarial streams: a wrong proposal costs one verify
    mismatch, never a wrong token.
    """

    def __init__(self, seed: int = 0, max_contexts: int = 65536,
                 max_successors: int = 8) -> None:
        self.seed = int(seed)
        self.order = ORDER
        self._max_contexts = int(max_contexts)
        self._max_successors = int(max_successors)
        # context tuple (1 or 2 tokens) -> {next_token: count}
        self._chains: "OrderedDict[Tuple[int, ...], Dict[int, int]]" = OrderedDict()
        # () context: most common stream-opening token (decoder streams
        # all start from BOS, so first tokens correlate across requests).
        self._starts: Dict[int, int] = {}
        self.observed = 0

    # ------------------------------------------------------------- learn
    def observe(self, tokens: Sequence[int], context: Sequence[int] = ()) -> None:
        """Fold a committed token run into the chains.

        ``context`` is the tail of tokens committed *before* this run
        (the engine passes the request's last ``order`` tokens); only
        transitions whose successor lies inside ``tokens`` are counted,
        so re-passing the context never double-counts.
        """
        toks = [int(t) for t in tokens]
        if not toks:
            return
        ctx = [int(t) for t in context][-self.order:]
        if not ctx:
            self._starts[toks[0]] = self._starts.get(toks[0], 0) + 1
        stream = ctx + toks
        base = len(ctx)
        for i in range(base, len(stream)):
            nxt = stream[i]
            for n in (1, 2):
                if i - n < 0:
                    continue
                key = tuple(stream[i - n:i])
                self._bump(key, nxt)
        self.observed += len(toks)

    def _bump(self, key: Tuple[int, ...], nxt: int) -> None:
        succ = self._chains.get(key)
        if succ is None:
            while len(self._chains) >= self._max_contexts:
                self._chains.popitem(last=False)
            succ = {}
            self._chains[key] = succ
        else:
            self._chains.move_to_end(key)
        succ[nxt] = succ.get(nxt, 0) + 1
        if len(succ) > self._max_successors:
            # Drop the rarest successor (ties: largest token id goes).
            drop = min(succ.items(), key=lambda kv: (kv[1], -kv[0]))[0]
            del succ[drop]

    # ----------------------------------------------------------- propose
    def _next(self, context: Sequence[int]) -> Optional[int]:
        ctx = [int(t) for t in context]
        for n in (2, 1):
            if len(ctx) < n:
                continue
            succ = self._chains.get(tuple(ctx[-n:]))
            if succ:
                # Most frequent; ties break toward the smallest token id
                # so proposals are deterministic across dict orderings.
                return max(succ.items(), key=lambda kv: (kv[1], -kv[0]))[0]
        if not ctx and self._starts:
            return max(self._starts.items(), key=lambda kv: (kv[1], -kv[0]))[0]
        return None

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        """Greedy chain walk: up to ``k`` draft tokens following
        ``context`` (the request's committed + optimistically pending
        tail). Returns fewer than ``k`` — possibly none — when the
        chains run dry; an empty proposal means the slot rides the
        launch as a plain single-step decode."""
        out: List[int] = []
        ctx = [int(t) for t in context]
        for _ in range(max(int(k), 0)):
            nxt = self._next(ctx + out)
            if nxt is None:
                break
            out.append(nxt)
        return out

    # ------------------------------------------------------------- admin
    def __len__(self) -> int:
        return len(self._chains)
