"""Byte-level BPE tokenizer, HF GPT-2 vocab.json / merges.txt compatible.

Counterpart of ``neurondb_tpu/ml/bpe.py``, host code the device never
sees: GPT-2's reversible byte -> unicode map, greedy lowest-rank merges,
the GPT-2 pre-tokenization regex (with the ``regex`` module's exact
letter and number classes, or the ``re`` approximation where that
module is missing), ``byte_fallback()`` (256 byte tokens and an eos, for
random-init models) and a decode that stops at the first eos. The same
``vocab.json`` / ``merges.txt`` give the same ids and the same text as
the JAX class; ``tests/test_torch_gpt.py`` holds the two to each other
and to transformers' ``GPT2Tokenizer``.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

try:                                    # exact \p{L}/\p{N} classes
    import regex as _re
    _PAT = _re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
        r"|\s+(?!\S)|\s+")
except ImportError:                     # a machine without regex
    import re as _re
    _PAT = _re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+"
        r"|\s+(?!\S)|\s+")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map: the 188 visibly
    printable latin-1 bytes map to themselves; the rest shift into the
    256+ plane so every token string is printable and json-safe."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class BPETokenizer:
    """Byte-level BPE with HF GPT-2 semantics (greedy lowest-rank merge).

    ``vocab``: token string -> id. ``merges``: ordered (a, b) pairs.
    ``eos_id`` defaults to the ``<|endoftext|>`` entry when present.
    """

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 eos_token: str = "<|endoftext|>"):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.eos_token = eos_token
        self.eos_id = self.vocab.get(eos_token)
        self._b2u = bytes_to_unicode()
        self._u2b = {v: k for k, v in self._b2u.items()}
        self._cache: Dict[str, List[str]] = {}

    # ---- construction ----
    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "BPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                if line.startswith("#version"):
                    continue
                parts = line.split()  # tolerate trailing/extra whitespace, as HF does
                if len(parts) != 2:
                    continue
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    @classmethod
    def from_dir(cls, path: str) -> "BPETokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"))

    @classmethod
    def byte_fallback(cls) -> "BPETokenizer":
        """No-merge byte vocabulary (256 tokens + eos) — lets GPT2LM run
        generatively with random-init weights in zero-egress tests."""
        b2u = bytes_to_unicode()
        vocab = {b2u[b]: b for b in range(256)}
        vocab["<|endoftext|>"] = 256
        return cls(vocab, [])

    # ---- core BPE ----
    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        pieces = list(word)
        if len(self._cache) < 65536:
            self._cache[token] = pieces
        return pieces

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for tok in _PAT.findall(text):
            mapped = "".join(self._b2u[b] for b in tok.encode("utf-8"))
            pieces.extend(self._bpe(mapped))
        return pieces

    def encode(self, text: str) -> List[int]:
        unk = self.eos_id if self.eos_id is not None else 0
        return [self.vocab.get(p, unk) for p in self.tokenize(text)]

    def decode(self, ids: Iterable[int]) -> str:
        # Stop at the first eos (everything after it is generation padding);
        # eos occurrences never appear mid-text in well-formed output, and
        # truncating — rather than filtering every occurrence — preserves
        # prompts that legitimately contain the eos string earlier.
        toks: List[str] = []
        for i in ids:
            i = int(i)
            if self.eos_id is not None and i == self.eos_id:
                break
            toks.append(self.inv_vocab.get(i, ""))
        parts: List[str] = []
        buf: List[int] = []
        for tok in toks:
            if all(c in self._u2b for c in tok):
                buf.extend(self._u2b[c] for c in tok)
            else:  # added/special token outside the byte plane: verbatim
                if buf:
                    parts.append(bytes(buf).decode("utf-8", errors="replace"))
                    buf = []
                parts.append(tok)
        if buf:
            parts.append(bytes(buf).decode("utf-8", errors="replace"))
        return "".join(parts)

    def __len__(self) -> int:
        return len(self.vocab)
