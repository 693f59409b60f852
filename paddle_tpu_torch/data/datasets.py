"""Shared text-dataset utilities for the demo data converters.

Role analog of the reference's per-demo preprocess scripts
(demo/quick_start/preprocess.py create_dict/tokenize, demo/seqToseq's
dict+sbeos corpus layout): tokenization, frequency-ordered dictionaries,
and the two line formats every text demo uses —

  labeled lines:   "<label>\t<text>"   (reference sentiment used
                   "<label>\t\t<text>"; both are accepted on read)
  parallel lines:  "<source sentence>\t<target sentence>"

Dictionaries are one word per line, id = line number; sequence dicts
reserve <s>/<e>/<unk> as ids 0/1/2 (the reference seqToseq convention).
"""

from __future__ import annotations

import gzip
import os
import re
from functools import lru_cache as _functools_lru_cache
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

__all__ = [
    "tokenize",
    "build_dict",
    "save_dict",
    "load_dict",
    "read_labeled_lines",
    "write_labeled_lines",
    "read_parallel_lines",
    "open_maybe_gz",
    "labeled_samples_or_synth",
    "resolve_word_dict",
    "SEQ_RESERVED",
]

_TOKEN_RE = re.compile(r"[a-z0-9']+")
SEQ_RESERVED = ("<s>", "<e>", "<unk>")


def tokenize(text: str) -> List[str]:
    """Lowercase word tokens (alphanumerics + apostrophes). A deliberate
    simplification of the reference's mosesdecoder tokenizer — documented
    in doc/divergences.md; the corpus format is tokenizer-agnostic."""
    return _TOKEN_RE.findall(text.lower())


def open_maybe_gz(path: str, mode: str = "rt"):
    return gzip.open(path, mode) if str(path).endswith(".gz") else open(path, mode)


def build_dict(
    token_streams: Iterable[Sequence[str]],
    max_size: int = 0,
    cutoff: int = 0,
    reserved: Sequence[str] = (),
) -> List[str]:
    """Frequency-descending word list (ties broken alphabetically so the
    output is deterministic). reserved words head the list regardless of
    frequency; cutoff drops words seen fewer times; max_size bounds the
    total length (reserved included)."""
    counts: Dict[str, int] = {}
    for toks in token_streams:
        for t in toks:
            counts[t] = counts.get(t, 0) + 1
    for r in reserved:
        counts.pop(r, None)
    words = sorted(counts, key=lambda w: (-counts[w], w))
    if cutoff:
        words = [w for w in words if counts[w] >= cutoff]
    out = list(reserved) + words
    return out[:max_size] if max_size else out


def save_dict(words: Sequence[str], path: str) -> None:
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")


def load_dict(path: str) -> Dict[str, int]:
    """word -> id from a one-word-per-line file (id = line number).
    Memoized for the process lifetime: configs and provider hooks both
    resolve the same dict at startup (a 30k-word file parses once)."""
    return dict(_load_dict_cached(os.path.abspath(path)))


@_functools_lru_cache(maxsize=16)
def _load_dict_cached(path: str):
    with open(path) as f:
        return tuple((w.strip(), i) for i, w in enumerate(f) if w.strip())


def read_labeled_lines(path: str) -> Iterator[Tuple[int, List[str]]]:
    """Yield (label, words) from '<label>\\t<text>' lines; tolerates the
    reference's double-tab separator and skips malformed lines."""
    with open_maybe_gz(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t", 1)
            if len(parts) != 2:
                continue
            label, text = parts[0], parts[1].lstrip("\t")
            try:
                yield int(label), text.split()
            except ValueError:
                continue


def write_labeled_lines(samples: Iterable[Tuple[int, Sequence[str]]], path: str) -> int:
    n = 0
    with open(path, "w") as f:
        for label, words in samples:
            f.write(f"{label}\t{' '.join(words)}\n")
            n += 1
    return n


def labeled_samples_or_synth(file_name: str, synth_fn, n: int):
    """The demos' file-list dispatch: an entry that exists on disk is read
    as a converted '<label>\\t<text>' corpus; anything else is a seed
    token for the demo's synthetic generator synth_fn(seed, n)."""
    if os.path.exists(file_name):
        yield from read_labeled_lines(file_name)
    else:
        yield from synth_fn(file_name, n)


def resolve_word_dict(dict_path: str, fallback_vocab: Sequence[str]) -> Dict[str, int]:
    """word->id map: the converter-written dict file when a path is given,
    else enumerate the demo's synthetic vocabulary."""
    if dict_path:
        return load_dict(dict_path)
    return {w: i for i, w in enumerate(fallback_vocab)}


def read_parallel_lines(path: str) -> Iterator[Tuple[List[str], List[str]]]:
    """Yield (source_words, target_words) from '<src>\\t<trg>' lines."""
    with open_maybe_gz(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 2:
                continue
            yield parts[0].split(), parts[1].split()
