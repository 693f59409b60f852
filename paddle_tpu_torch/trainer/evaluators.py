"""Evaluator runtime.

Reference: /root/reference/paddle/gserver/evaluators/Evaluator.cpp
(ClassificationErrorEvaluator:41, SumEvaluator:151, ColumnSumEvaluator:243,
AucEvaluator Evaluator.h:155, PrecisionRecallEvaluator:234, printers
:870-1235), ChunkEvaluator.cpp, CTCErrorEvaluator.cpp.

Evaluators accumulate over batches on the host (numpy) from layer outputs —
they're observability, not part of the jitted step.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.proto import EvaluatorConfig, ModelConfig
from paddle_tpu_torch.utils.registry import Registry

evaluator_registry: Registry[type] = Registry("evaluator")


def register_evaluator(*names):
    return evaluator_registry.register(*names)


class Evaluator:
    def __init__(self, cfg: EvaluatorConfig):
        self.cfg = cfg
        self.start()

    def start(self) -> None:
        raise NotImplementedError

    def eval_batch(self, args: List[Argument]) -> None:
        raise NotImplementedError

    def result(self) -> Dict[str, float]:
        raise NotImplementedError

    def summary(self) -> str:
        return " ".join(f"{k}={v:.6g}" for k, v in self.result().items())

    # -- distributed merging (the reference's Evaluator::getState /
    # mergeState split, Evaluator.h:81-82: trainers ship a SMALL
    # accumulated state once per period instead of raw activations
    # per batch)

    def merge_state(self) -> Optional[np.ndarray]:
        """Flat float64 vector of accumulated state that merges across
        processes by SUMMATION, or None if this evaluator cannot merge
        that way (raw-record evaluators, printers) — those eval gathered
        full outputs per batch instead."""
        return None

    def load_state(self, vec: np.ndarray) -> None:
        """Inverse of merge_state: replace accumulators with vec."""
        raise NotImplementedError(type(self).__name__)

    # -- helpers

    @staticmethod
    def _rows(arg: Argument) -> np.ndarray:
        """Flatten an output to valid rows [N, D] (masking padding)."""
        v = np.asarray(arg.value) if arg.value is not None else None
        if v is None:
            ids = np.asarray(arg.ids)
            v = ids.reshape(ids.shape + (1,)).astype(np.float32)
        if arg.sub_seq_lengths is not None:
            lens = np.asarray(arg.sub_seq_lengths)
            rows = [
                v[b, s, :t]
                for b in range(v.shape[0])
                for s, t in enumerate(lens[b])
                if t > 0
            ]
            return np.concatenate(rows, axis=0) if rows else v.reshape(0, v.shape[-1])
        if arg.seq_lengths is not None:
            lens = np.asarray(arg.seq_lengths)
            rows = [v[b, : lens[b]] for b in range(v.shape[0])]
            return np.concatenate(rows, axis=0) if rows else v.reshape(0, v.shape[-1])
        return v

    @staticmethod
    def _label_rows(arg: Argument) -> np.ndarray:
        if arg.ids is not None:
            ids = np.asarray(arg.ids)
            if arg.seq_lengths is not None and ids.ndim >= 2:
                lens = np.asarray(arg.seq_lengths)
                return np.concatenate([ids[b, : lens[b]].reshape(-1) for b in range(ids.shape[0])])
            return ids.reshape(-1)
        return np.argmax(Evaluator._rows(arg), axis=-1)


@register_evaluator("classification_error")
class ClassificationErrorEvaluator(Evaluator):
    def start(self):
        self.wrong = 0.0
        self.total = 0.0

    def eval_batch(self, args):
        out, label = args[0], args[1]
        probs = self._rows(out)
        labels = self._label_rows(label)
        if self.cfg.classification_threshold > 0 and probs.shape[-1] == 1:
            pred = (probs[:, 0] > self.cfg.classification_threshold).astype(np.int64)
        else:
            pred = np.argmax(probs, axis=-1)
        n = min(len(pred), len(labels))
        self.wrong += float(np.sum(pred[:n] != labels[:n]))
        self.total += n

    def result(self):
        return {"classification_error": self.wrong / max(self.total, 1.0)}

    def merge_state(self):
        return np.array([self.wrong, self.total], np.float64)

    def load_state(self, vec):
        self.wrong, self.total = float(vec[0]), float(vec[1])


@register_evaluator("sum")
class SumEvaluator(Evaluator):
    def start(self):
        self.sum = 0.0
        self.total = 0.0

    def eval_batch(self, args):
        rows = self._rows(args[0])
        self.sum += float(rows.sum())
        self.total += rows.shape[0]

    def result(self):
        return {"sum": self.sum, "mean": self.sum / max(self.total, 1.0)}

    def merge_state(self):
        return np.array([self.sum, self.total], np.float64)

    def load_state(self, vec):
        self.sum, self.total = float(vec[0]), float(vec[1])


@register_evaluator("last-column-sum")
class ColumnSumEvaluator(Evaluator):
    def start(self):
        self.sum = 0.0
        self.total = 0.0

    def eval_batch(self, args):
        rows = self._rows(args[0])
        self.sum += float(rows[:, -1].sum())
        self.total += rows.shape[0]

    def result(self):
        return {"column_sum": self.sum, "column_mean": self.sum / max(self.total, 1.0)}

    def merge_state(self):
        return np.array([self.sum, self.total], np.float64)

    def load_state(self, vec):
        self.sum, self.total = float(vec[0]), float(vec[1])


@register_evaluator("last-column-auc")
class AucEvaluator(Evaluator):
    """Histogram AUC like the reference (AucEvaluator, Evaluator.h:155)."""

    BINS = 4096

    def start(self):
        self.pos = np.zeros(self.BINS)
        self.neg = np.zeros(self.BINS)

    def eval_batch(self, args):
        out, label = args[0], args[1]
        scores = self._rows(out)[:, -1]
        labels = self._label_rows(label)
        # optional third input: per-sample weight (adds w to the bin,
        # reference Evaluator.cpp statPos_/statNeg_ += w)
        w = (self._rows(args[2])[:, -1] if len(args) > 2
             else np.ones_like(scores, np.float64))
        idx = np.clip((scores * (self.BINS - 1)).astype(np.int64), 0, self.BINS - 1)
        np.add.at(self.pos, idx[labels == 1], w[labels == 1])
        np.add.at(self.neg, idx[labels != 1], w[labels != 1])

    def result(self):
        # trapezoidal over descending threshold
        tp = np.cumsum(self.pos[::-1])
        fp = np.cumsum(self.neg[::-1])
        tot_p, tot_n = tp[-1] if len(tp) else 0.0, fp[-1] if len(fp) else 0.0
        if tot_p == 0 or tot_n == 0:
            return {"auc": 0.0}
        tpr = np.concatenate([[0.0], tp / tot_p])
        fpr = np.concatenate([[0.0], fp / tot_n])
        auc = float(np.trapezoid(tpr, fpr))
        return {"auc": auc}

    def merge_state(self):
        return np.concatenate([self.pos, self.neg]).astype(np.float64)

    def load_state(self, vec):
        self.pos = np.asarray(vec[: self.BINS], np.float64)
        self.neg = np.asarray(vec[self.BINS :], np.float64)


@register_evaluator("seq_classification_error")
class SequenceClassificationErrorEvaluator(Evaluator):
    """Per-sequence error (ref: SequenceClassificationErrorEvaluator,
    Evaluator.cpp:111): a sequence counts as wrong if ANY valid frame's
    argmax disagrees with the label."""

    def start(self):
        self.wrong = 0.0
        self.total = 0.0

    def eval_batch(self, args):
        out, label = args[0], args[1]
        v = np.asarray(out.value)                       # [B, T, C]
        pred = np.argmax(v, axis=-1)
        labels = np.asarray(label.ids)
        lens = (
            np.asarray(out.seq_lengths)
            if out.seq_lengths is not None
            else np.full((v.shape[0],), v.shape[1], np.int64)
        )
        for b in range(v.shape[0]):
            t = int(lens[b])
            lb = labels[b] if labels.ndim > 1 else np.full((t,), labels[b])
            self.wrong += float(np.any(pred[b, :t] != lb[:t]))
            self.total += 1.0

    def result(self):
        return {"seq_classification_error": self.wrong / max(self.total, 1.0)}

    def merge_state(self):
        return np.array([self.wrong, self.total], np.float64)

    def load_state(self, vec):
        self.wrong, self.total = float(vec[0]), float(vec[1])


@register_evaluator("rank-auc")
class RankAucEvaluator(Evaluator):
    """AUC over rank-model scores (ref: RankAucEvaluator, Evaluator.h:202):
    inputs = output score, click (label), optional pv (weight). Exact AUC
    over the accumulated (score, click, pv) triples."""

    def start(self):
        self.scores = []
        self.clicks = []
        self.pvs = []

    def eval_batch(self, args):
        out = self._rows(args[0])[:, -1]
        click = self._rows(args[1])[:, -1]
        pv = self._rows(args[2])[:, -1] if len(args) > 2 else np.ones_like(click)
        self.scores.append(out)
        self.clicks.append(click)
        self.pvs.append(pv)

    def result(self):
        if not self.scores:
            return {"rank_auc": 0.0}
        s = np.concatenate(self.scores)
        click = np.concatenate(self.clicks)
        pv = np.concatenate(self.pvs)
        # group by unique score so tied pos/neg pairs count 0.5 each
        # (order-independent AUC)
        uniq, inv = np.unique(s, return_inverse=True)
        pos_g = np.bincount(inv, weights=click, minlength=len(uniq))
        neg_g = np.bincount(inv, weights=pv - click, minlength=len(uniq))
        cum_neg_below = np.cumsum(neg_g) - neg_g   # strictly lower scores
        pairs_correct = float(np.sum(pos_g * (cum_neg_below + 0.5 * neg_g)))
        total_pairs = float(pos_g.sum() * neg_g.sum())
        return {"rank_auc": pairs_correct / total_pairs if total_pairs else 0.0}


@register_evaluator("precision_recall")
class PrecisionRecallEvaluator(Evaluator):
    def start(self):
        self.tp: Dict[int, float] = {}
        self.fp: Dict[int, float] = {}
        self.fn: Dict[int, float] = {}

    def eval_batch(self, args):
        out, label = args[0], args[1]
        probs = self._rows(out)
        labels = self._label_rows(label)
        pred = np.argmax(probs, axis=-1)
        for p, l in zip(pred, labels):
            p, l = int(p), int(l)
            if p == l:
                self.tp[l] = self.tp.get(l, 0) + 1
            else:
                self.fp[p] = self.fp.get(p, 0) + 1
                self.fn[l] = self.fn.get(l, 0) + 1

    def result(self):
        classes = set(self.tp) | set(self.fp) | set(self.fn)
        if self.cfg.positive_label >= 0:
            classes = {self.cfg.positive_label}
        precs, recs = [], []
        for c in classes:
            tp = self.tp.get(c, 0.0)
            fp = self.fp.get(c, 0.0)
            fn = self.fn.get(c, 0.0)
            precs.append(tp / max(tp + fp, 1.0))
            recs.append(tp / max(tp + fn, 1.0))
        p = float(np.mean(precs)) if precs else 0.0
        r = float(np.mean(recs)) if recs else 0.0
        f1 = 2 * p * r / max(p + r, 1e-9)
        return {"precision": p, "recall": r, "F1": f1}


@register_evaluator("pnpair")
class PnpairEvaluator(Evaluator):
    """Positive-negative pair ordering accuracy (ref Evaluator.h:308)."""

    def start(self):
        self.records: List = []

    def eval_batch(self, args):
        out, label = args[0], args[1]
        scores = self._rows(out)[:, -1]
        labels = self._label_rows(label)
        # optional third input: query id for grouping; fourth: weight
        if len(args) > 2:
            qids = self._label_rows(args[2])
        else:
            qids = np.zeros_like(labels)
        w = (self._rows(args[3])[:, -1] if len(args) > 3
             else np.ones_like(scores, np.float64))
        self.records.extend(
            zip(qids.tolist(), labels.tolist(), scores.tolist(), w.tolist()))

    def result(self):
        from collections import defaultdict

        by_q = defaultdict(list)
        for q, l, s, w in self.records:
            by_q[q].append((l, s, w))
        pos_minus_neg = 0.0
        total = 0.0
        CHUNK = 256  # bounds pair-walk temporaries to CHUNK*n entries
        for items in by_q.values():
            # vectorized pair walk in row chunks (semantics identical to
            # the reference's O(n^2) loop, PnpairEvaluator::stat: pair
            # weight = mean of the two samples' weights, ties 0.5) —
            # memory stays O(CHUNK*n) even when every record lands in one
            # group (the no-qid default)
            n = len(items)
            l = np.asarray([it[0] for it in items], np.float64)
            sc = np.asarray([it[1] for it in items], np.float64)
            w = np.asarray([it[2] for it in items], np.float64)
            col = np.arange(n)
            for i0 in range(0, n - 1, CHUNK):
                rows = np.arange(i0, min(i0 + CHUNK, n - 1))
                pair = col[None, :] > rows[:, None]          # j > i
                diff = pair & (l[None, :] != l[rows][:, None])
                if not diff.any():
                    continue
                ri, cj = np.nonzero(diff)
                iu, ju = rows[ri], cj
                pw = (w[iu] + w[ju]) / 2.0
                hi_is_i = l[iu] > l[ju]
                hi = np.where(hi_is_i, sc[iu], sc[ju])
                lo = np.where(hi_is_i, sc[ju], sc[iu])
                total += float(pw.sum())
                pos_minus_neg += float(pw[hi > lo].sum() + 0.5 * pw[hi == lo].sum())
        # raw total as the denominator: max(total, 1) would deflate the
        # metric whenever the total pair weight is < 1
        return {"pnpair_accuracy": pos_minus_neg / total if total > 0 else 0.0}


@register_evaluator("ctc_edit_distance")
class CTCErrorEvaluator(Evaluator):
    """Edit distance between CTC best-path decode and the label sequence
    (ref: CTCErrorEvaluator.cpp)."""

    def start(self):
        self.dist = 0.0
        self.total_labels = 0.0

    @staticmethod
    def _edit_distance(a, b) -> int:
        la, lb = len(a), len(b)
        dp = list(range(lb + 1))
        for i in range(1, la + 1):
            prev = dp[0]
            dp[0] = i
            for j in range(1, lb + 1):
                cur = dp[j]
                dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (a[i - 1] != b[j - 1]))
                prev = cur
        return dp[lb]

    def eval_batch(self, args):
        out, label = args[0], args[1]
        probs = np.asarray(out.value)  # [B, T, C] (blank = C-1)
        lens = np.asarray(out.seq_lengths)
        blank = probs.shape[-1] - 1
        label_ids = np.asarray(label.ids)
        label_lens = np.asarray(label.seq_lengths)
        for b in range(probs.shape[0]):
            path = np.argmax(probs[b, : lens[b]], axis=-1)
            decoded = []
            prev = -1
            for p in path:
                if p != prev and p != blank:
                    decoded.append(int(p))
                prev = p
            target = label_ids[b, : label_lens[b]].tolist()
            self.dist += self._edit_distance(decoded, target)
            self.total_labels += len(target)

    def result(self):
        return {"ctc_error_rate": self.dist / max(self.total_labels, 1.0)}

    def merge_state(self):
        return np.array([self.dist, self.total_labels], np.float64)

    def load_state(self, vec):
        self.dist, self.total_labels = float(vec[0]), float(vec[1])


@register_evaluator("chunk")
class ChunkEvaluator(Evaluator):
    """IOB/IOE/IOBES chunking F1 (ref: ChunkEvaluator.cpp)."""

    def start(self):
        self.correct = 0.0
        self.pred_chunks = 0.0
        self.label_chunks = 0.0

    def _extract_chunks(self, tags: List[int]):
        """tag = type * tagsPerType + posInScheme. IOB: 0=B,1=I; IOE: 0=I,
        1=E; IOBES: 0=B,1=I,2=E,3=S; 'other' = last tag id."""
        scheme = self.cfg.chunk_scheme
        n_types = self.cfg.num_chunk_types
        per = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
        other = n_types * per
        chunks = []
        start = None
        ctype = None
        for i, t in enumerate(tags + [other]):
            if t >= other:
                tt, pos = None, None
            else:
                tt, pos = t // per, t % per
            begin = False
            end_prev = False
            if scheme == "IOB":
                begin = pos == 0
                end_prev = tt is None or (start is not None and (pos == 0 or tt != ctype))
            elif scheme == "IOE":
                begin = start is None and tt is not None
                end_prev = start is not None and (ctype != tt or (i > 0 and tags[i - 1] % per == 1))
            elif scheme == "IOBES":
                begin = pos in (0, 3)
                end_prev = tt is None or (start is not None and (pos in (0, 3) or tt != ctype))
            else:  # plain: every tag is its own chunk type, 'other' closes
                begin = tt is not None and tt != ctype
                end_prev = start is not None and tt != ctype
            if end_prev and start is not None:
                chunks.append((start, i - 1, ctype))
                start = None
            if begin and tt is not None:
                start = i
                ctype = tt
            elif tt is None:
                start = None
                ctype = None
        return set(chunks)

    def eval_batch(self, args):
        out, label = args[0], args[1]
        preds = self._label_rows(out)
        labels = self._label_rows(label)
        pred_chunks = self._extract_chunks([int(x) for x in preds])
        label_chunks = self._extract_chunks([int(x) for x in labels])
        self.correct += len(pred_chunks & label_chunks)
        self.pred_chunks += len(pred_chunks)
        self.label_chunks += len(label_chunks)

    def result(self):
        p = self.correct / max(self.pred_chunks, 1.0)
        r = self.correct / max(self.label_chunks, 1.0)
        return {"precision": p, "recall": r, "F1": 2 * p * r / max(p + r, 1e-9)}


class _PrinterEvaluator(Evaluator):
    def start(self):
        self.lines: List[str] = []

    def result(self):
        return {}

    def summary(self):
        return "\n".join(self.lines[-5:])


@register_evaluator("value_printer")
class ValuePrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, args):
        self.lines.append(str(self._rows(args[0])[:4]))


@register_evaluator("gradient_printer")
class GradientPrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, args):
        self.lines.append("<gradients not captured in functional mode>")


@register_evaluator("max_id_printer")
class MaxIdPrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, args):
        rows = self._rows(args[0])
        self.lines.append(str(np.argsort(-rows, axis=-1)[:4, : max(1, self.cfg.num_results)]))


@register_evaluator("max_frame_printer")
class MaxFramePrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, args):
        rows = self._rows(args[0])
        self.lines.append(str(rows.max(axis=-1)[:4]))


@register_evaluator("seq_text_printer")
class SeqTextPrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, args):
        arg = args[-1]
        ids = np.asarray(arg.ids) if arg.ids is not None else np.argmax(np.asarray(arg.value), -1)
        vocab = None
        if self.cfg.dict_file:
            try:
                with open(self.cfg.dict_file) as f:
                    vocab = [l.rstrip("\n") for l in f]
            except OSError:
                vocab = None
        for row in ids[:4]:
            toks = [vocab[t] if vocab and t < len(vocab) else str(int(t)) for t in np.atleast_1d(row)]
            line = (" " if self.cfg.delimited else "").join(toks)
            self.lines.append(line)
        if self.cfg.result_file:
            with open(self.cfg.result_file, "a") as f:
                for row in ids:
                    toks = [
                        vocab[t] if vocab and t < len(vocab) else str(int(t))
                        for t in np.atleast_1d(row)
                    ]
                    f.write((" " if self.cfg.delimited else "").join(toks) + "\n")


@register_evaluator("classification_error_printer")
class ClassificationErrorPrinterEvaluator(_PrinterEvaluator):
    def eval_batch(self, args):
        out, label = args[0], args[1]
        probs = self._rows(out)
        labels = self._label_rows(label)
        pred = np.argmax(probs, axis=-1)
        err = (pred != labels).astype(np.float32)
        self.lines.append(str(err[:16]))


class EvaluatorChain:
    """All configured evaluators of a model, fed from layer outputs."""

    def __init__(self, model: ModelConfig, names: Optional[List[str]] = None):
        self.model = model
        self.evaluators: List[Evaluator] = []
        # set by the trainer in multi-process runs when evaluators were fed
        # process-local rows: vec -> cross-process SUM of vec. Reading
        # results then merges sufficient statistics once — the reference's
        # distributeEval (Evaluator.h:81-82) — instead of gathering raw
        # activations every batch.
        self.merge_fn = None
        for cfg in model.evaluators:
            if names is not None and cfg.name not in names:
                continue
            if cfg.type in evaluator_registry:
                self.evaluators.append(evaluator_registry.get(cfg.type)(cfg))

    def partition(self):
        """(mergeable, unmergeable) evaluators: mergeable ones carry
        summable state and can accumulate on local rows."""
        merge, gather = [], []
        for e in self.evaluators:
            (merge if e.merge_state() is not None else gather).append(e)
        return merge, gather

    @staticmethod
    def layers_for(evaluators: List[Evaluator]) -> List[str]:
        seen: List[str] = []
        for e in evaluators:
            for n in e.cfg.input_layers:
                if n not in seen:
                    seen.append(n)
        return seen

    def _merged(self, e: Evaluator) -> Evaluator:
        """A view of e with cross-process-merged state (e itself keeps
        accumulating local rows; merging at read time is idempotent)."""
        vec = None if self.merge_fn is None else e.merge_state()
        if vec is None:
            return e
        clone = type(e)(e.cfg)
        clone.load_state(self.merge_fn(vec))
        return clone

    def __bool__(self) -> bool:
        return bool(self.evaluators)

    @property
    def needed_layers(self) -> List[str]:
        """Layer outputs the chain reads — multi-process runs gather only
        these to the host (distributeEval analog, Evaluator.h:81-82)."""
        seen: List[str] = []
        for e in self.evaluators:
            for n in e.cfg.input_layers:
                if n not in seen:
                    seen.append(n)
        return seen

    def start(self):
        for e in self.evaluators:
            e.start()

    def eval_batch(self, outputs: Dict[str, Argument], only: Optional[List[Evaluator]] = None):
        for e in (self.evaluators if only is None else only):
            args = [outputs[n] for n in e.cfg.input_layers if n in outputs]
            if len(args) == len(e.cfg.input_layers):
                e.eval_batch(args)

    def summary(self) -> str:
        parts = []
        for e in self.evaluators:
            s = self._merged(e).summary()
            if s:
                parts.append(f"{e.cfg.name}: {s}")
        return "  ".join(parts)

    def results(self) -> Dict[str, float]:
        out = {}
        for e in self.evaluators:
            for k, v in self._merged(e).result().items():
                out[f"{e.cfg.name}.{k}"] = v
        return out
