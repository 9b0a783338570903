"""WordPiece tokenization: the text front-end for the transformer families —
carried from the JAX package.

The reference has no text processing (inputs are flat feature vectors); this
supplies the standard BERT scheme — basic tokenization (lowercase,
punctuation split) + greedy longest-match WordPiece with ``##`` continuations
— backed by the native C++ implementation (``native/tokenizer.cpp``,
GIL-free) with an identically-behaving pure-python fallback (both use ASCII
basic-tokenizer semantics; non-ASCII characters pass through un-lowercased
on both paths, so toolchain presence never changes tokenization).

:class:`WordpieceTokenizer` encodes batches of strings to fixed-shape
``(ids, mask)`` arrays ready for ``SparkAsyncDL`` with
``extraInputCols``/``extraTfInputs``; the localml/pyspark transformer wrapper
lives in :mod:`sparkflow_tpu_torch.localml.feature` (``WordpieceEncoder``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..native.build import load_library


_ASCII_SPACE = " \t\n\r\v\f"
_ASCII_PUNCT = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _basic_split(text: str) -> List[str]:
    """ASCII basic-tokenizer: lowercase (ASCII only), whitespace split,
    punctuation as single tokens. Mirrors the native path exactly — non-ASCII
    characters pass through un-lowercased on BOTH paths (the C++ side is
    byte-wise C-locale), so toolchain presence never changes tokenization."""
    out: List[str] = []
    cur: List[str] = []
    for ch in text:
        if ch in _ASCII_SPACE:
            if cur:
                out.append("".join(cur))
                cur = []
        elif ch in _ASCII_PUNCT:
            if cur:
                out.append("".join(cur))
                cur = []
            out.append(ch)
        else:
            cur.append(ch.lower() if ch.isascii() else ch)
    if cur:
        out.append("".join(cur))
    return out


class WordpieceTokenizer:
    """Greedy longest-match WordPiece over a fixed vocab.

    ``vocab`` maps position -> token (a list); continuations carry the
    ``##`` prefix. ``unk_token``/``pad_token`` must be present in the vocab.
    """

    def __init__(self, vocab: Sequence[str], unk_token: str = "[UNK]",
                 pad_token: str = "[PAD]", use_native: bool = True):
        self.vocab = list(vocab)
        self.index = {t: i for i, t in enumerate(self.vocab)}
        for tok in (unk_token, pad_token):
            if tok not in self.index:
                raise ValueError(f"{tok!r} missing from vocab")
        self.unk_id = self.index[unk_token]
        self.pad_id = self.index[pad_token]
        self._max_len = max(len(t) for t in self.vocab)
        self._native = None
        if use_native:
            lib = load_library()
            if lib is not None:
                blob = "\n".join(self.vocab).encode("utf-8")
                self._blob = ctypes.create_string_buffer(blob, len(blob))
                self._native = lib
                self._handle = lib.sft_create(self._blob, len(blob),
                                              len(self.vocab))

    def __del__(self):
        if getattr(self, "_native", None) is not None and self._handle:
            try:
                self._native.sft_destroy(self._handle)
            except Exception:
                pass

    # -- encoding ------------------------------------------------------------

    def _encode_py(self, text: str, max_len: int,
                   ids: np.ndarray, mask: np.ndarray) -> int:
        w = 0
        for word in _basic_split(text):
            if w >= max_len:
                break
            pos, pieces, bad = 0, [], False
            while pos < len(word):
                found, found_len = -1, 0
                top = min(len(word) - pos, self._max_len)
                for ln in range(top, 0, -1):
                    cand = ("##" if pos else "") + word[pos:pos + ln]
                    tid = self.index.get(cand)
                    if tid is not None:
                        found, found_len = tid, ln
                        break
                if found < 0:
                    bad = True
                    break
                pieces.append(found)
                pos += found_len
            chosen = [self.unk_id] if bad else pieces
            for p in chosen:
                if w >= max_len:
                    break
                ids[w] = p
                mask[w] = 1.0
                w += 1
        return w

    def _encode_into(self, text: str, max_len: int,
                     ids: np.ndarray, mask: np.ndarray) -> None:
        """Write one row in place (ids row prefilled with pad, mask zeros
        done by callers; both buffers must be C-contiguous rows)."""
        if self._native is not None:
            self._native.sft_encode(
                self._handle, text.encode("utf-8"),
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                max_len, self.unk_id, self.pad_id)
        else:
            self._encode_py(text, max_len, ids, mask)

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """One string -> (ids [max_len] int32, mask [max_len] float32)."""
        ids = np.full((max_len,), self.pad_id, np.int32)
        mask = np.zeros((max_len,), np.float32)
        self._encode_into(text, max_len, ids, mask)
        return ids, mask

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Strings -> (ids [n, max_len], mask [n, max_len]) fixed shapes;
        one native call per batch (rows written in place)."""
        n = len(texts)
        ids = np.full((n, max_len), self.pad_id, np.int32)
        mask = np.zeros((n, max_len), np.float32)
        if self._native is not None and n:
            # newlines act as the row separator in the blob: normalize them
            # to spaces (identical tokenization — both are whitespace)
            blob = "\n".join(t.replace("\n", " ") for t in texts).encode("utf-8")
            self._native.sft_encode_batch(
                self._handle, blob, len(blob), n,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                max_len, self.unk_id, self.pad_id)
        else:
            for i, t in enumerate(texts):
                self._encode_into(t, max_len, ids[i], mask[i])
        return ids, mask

    @classmethod
    def from_file(cls, path: str, **kw) -> "WordpieceTokenizer":
        with open(path) as f:
            return cls([line.rstrip("\n") for line in f if line.strip()], **kw)


def build_vocab(texts: Sequence[str], max_size: int = 30000,
                specials: Sequence[str] = ("[PAD]", "[UNK]")) -> List[str]:
    """Frequency word-level vocab (whole words; no subword merges) — enough
    for self-contained examples and tests; real deployments load a published
    WordPiece vocab via :meth:`WordpieceTokenizer.from_file`."""
    from collections import Counter
    counts: Counter = Counter()
    for t in texts:
        counts.update(_basic_split(t))
    vocab = list(specials)
    for tok, _n in counts.most_common(max_size - len(vocab)):
        vocab.append(tok)
    return vocab
