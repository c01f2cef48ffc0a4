"""WordPiece tokenizer: BERT's basic + WordPiece scheme over an HF vocab.

Counterpart of ``neurondb_tpu/ml/tokenizer.py``, pure Python and numpy,
giving the same ids, type ids and framing:

- ``BasicTokenizer``: unicode cleanup, lowercasing and accent stripping
  (configurable), punctuation splitting, CJK characters on their own; an
  ASCII fast path (one regex pass) with the same semantics;
- ``WordPieceTokenizer``: greedy longest-match-first subwords with ``##``
  continuations and an ``[UNK]`` fallback, a bounded per-word memo;
- ``encode`` / ``encode_pair`` with ``[CLS]``/``[SEP]`` framing and token
  type ids; ``encode_pair`` truncates the longer side first (HF
  ``longest_first``).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

# ASCII fast path: for pure-ASCII text the basic tokenizer reduces to
# "alnum runs are words; every other printable char is its own token;
# control chars vanish". NFD/Mn stripping is a no-op on ASCII.
_ASCII_LOWER = re.compile(r"[a-z0-9]+|[^a-z0-9\s\x00-\x1f\x7f]")
_ASCII_ANY = re.compile(r"[A-Za-z0-9]+|[^A-Za-z0-9\s\x00-\x1f\x7f]")
# control chars other than \t\n\r are REMOVED (adjacent words join),
# exactly like the char-loop path / HF _clean_text
_CTRL_DEL = {c: None for c in (*range(0, 9), 11, 12, *range(14, 32), 127)}

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)


class BasicTokenizer:
    def __init__(self, lowercase: bool = True):
        self.lowercase = lowercase

    def tokenize(self, text: str) -> List[str]:
        if text.isascii():
            text = text.translate(_CTRL_DEL)
            return (_ASCII_LOWER.findall(text.lower())
                    if self.lowercase else _ASCII_ANY.findall(text))
        out: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                out.append("".join(buf))
                buf.clear()

        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) == "Cc" \
                    and ch not in "\t\n\r":
                continue
            if ch.isspace():
                flush()
                continue
            if _is_cjk(cp) or _is_punct(ch):
                flush()
                out.append(ch)
                continue
            buf.append(ch)
        flush()
        if self.lowercase:
            out = [unicodedata.normalize("NFD", t.lower()) for t in out]
            out = ["".join(c for c in t
                           if unicodedata.category(c) != "Mn") or t
                   for t in out]
        return [t for t in out if t]


class WordPieceTokenizer:
    """BERT WordPiece over a vocab mapping token -> id."""

    def __init__(self, vocab: Dict[str, int], *, lowercase: bool = True,
                 max_word_chars: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.basic = BasicTokenizer(lowercase)
        self.max_word_chars = max_word_chars
        self.pad_id = vocab.get(PAD, 0)
        self.unk_id = vocab.get(UNK, 1)
        self.cls_id = vocab.get(CLS, 2)
        self.sep_id = vocab.get(SEP, 3)
        # word -> piece ids: wordpiece is deterministic per word and real
        # text repeats words heavily (bounded)
        self._word_cache: Dict[str, List[int]] = {}

    @classmethod
    def from_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        """Load an HF-format vocab.txt (one token per line, id = line)."""
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values()) + 1 if self.vocab else 0

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        pieces: List[int] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        cache = self._word_cache
        for word in self.basic.tokenize(text):
            pieces = cache.get(word)
            if pieces is None:
                pieces = self._wordpiece(word)
                if len(cache) < 1_000_000:
                    cache[word] = pieces
            ids.extend(pieces)
        return ids

    def tokenize(self, text: str) -> List[str]:
        return [self.ids_to_tokens.get(i, UNK)
                for i in self.tokenize_ids(text)]

    # ---- model-input encoding ----
    def encode(self, text: str, max_len: int = 128
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [max_len], type_ids [max_len]); 0-padded."""
        ids = [self.cls_id] + self.tokenize_ids(text)[: max_len - 2] \
            + [self.sep_id]
        out = np.full(max_len, self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out, np.zeros(max_len, np.int32)

    def encode_pair(self, a: str, b: str, max_len: int = 256
                    ) -> Tuple[np.ndarray, np.ndarray]:
        ta = self.tokenize_ids(a)
        tb = self.tokenize_ids(b)
        # truncate the longer side first (HF longest_first strategy)
        budget = max_len - 3
        while len(ta) + len(tb) > budget:
            (ta if len(ta) >= len(tb) else tb).pop()
        ids = [self.cls_id] + ta + [self.sep_id] + tb + [self.sep_id]
        types = [0] * (len(ta) + 2) + [1] * (len(tb) + 1)
        out = np.full(max_len, self.pad_id, np.int32)
        tout = np.zeros(max_len, np.int32)
        out[: len(ids)] = ids
        tout[: len(types)] = types
        return out, tout

    def encode_batch(self, texts: Sequence[str], max_len: int = 128
                     ) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode(t, max_len) for t in texts]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))
