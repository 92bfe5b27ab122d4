"""Text tokenization for conditioning (own copy of dcr_tpu/data/tokenizer.py).

- :class:`ClipBPETokenizer` — CLIP byte-pair encoding from local
  ``vocab.json``/``merges.txt`` files.
- :class:`HashTokenizer` — deterministic hashing tokenizer for tests and smoke
  runs.

Both give exactly the ids the JAX package's tokenizers give for the same text.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import json
import re
from functools import lru_cache
from pathlib import Path
from typing import Sequence

import numpy as np


class TokenizerBase:
    vocab_size: int
    model_max_length: int
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int

    def encode(self, text: str) -> list[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def _fingerprint_fields(self) -> dict:
        """Everything that determines the text -> ids mapping; subclasses add
        their vocab content. Must be JSON-serializable and order-stable."""
        return {"class": type(self).__name__, "vocab_size": self.vocab_size,
                "model_max_length": self.model_max_length,
                "bos": self.bos_token_id, "eos": self.eos_token_id,
                "pad": self.pad_token_id}

    def fingerprint(self) -> str:
        """Stable hex id of this tokenizer's text->ids mapping. Two tokenizers
        with the same fingerprint produce identical ids for identical text —
        the cache-key component the serve embedding cache (dcr_tpu/serve/)
        needs so a checkpoint swap can never serve stale embeddings."""
        payload = json.dumps(self._fingerprint_fields(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def __call__(self, texts: str | Sequence[str],
                 max_length: int | None = None) -> np.ndarray:
        """Tokenize with truncation + pad-to-max-length (reference
        datasets.py:144-150). Returns int32 [B, max_length]."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos_token_id] + self.encode(text)[: max_length - 2] + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# CLIP BPE (loads the standard vocab/merges files when available locally)
# ---------------------------------------------------------------------------

@lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer(TokenizerBase):
    """CLIP's BPE with end-of-word '</w>' markers, vocab 49408, context 77."""

    # ASCII approximation of CLIP's \p{L}/\p{N} pattern (stdlib `re` has no
    # unicode property classes; non-ASCII text falls through to the byte tokens)
    PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )

    def __init__(self, vocab_path: str | Path, merges_path: str | Path,
                 model_max_length: int = 77):
        vocab_path, merges_path = Path(vocab_path), Path(merges_path)
        # kept so trainers can republish the files into their output dir
        # (the diffusers `tokenizer/` subfolder contract)
        self.vocab_path, self.merges_path = vocab_path, merges_path
        self.encoder: dict[str, int] = json.loads(vocab_path.read_text(encoding="utf-8"))
        merges_raw = merges_path.read_bytes()
        merges_text = (gzip.decompress(merges_raw).decode("utf-8")
                       if merges_path.suffix == ".gz"
                       else merges_raw.decode("utf-8"))
        lines = merges_text.split("\n")
        if lines and lines[0].startswith("#"):
            lines = lines[1:]
        merges = [tuple(m.split()) for m in lines if len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.vocab_size = len(self.encoder)
        self.model_max_length = model_max_length
        self.bos_token_id = self.encoder.get("<|startoftext|>", self.vocab_size - 2)
        self.eos_token_id = self.encoder.get("<|endoftext|>", self.vocab_size - 1)
        self.pad_token_id = self.eos_token_id  # CLIP pads with EOT
        self._bpe_cache: dict[str, str] = {}

    def _fingerprint_fields(self) -> dict:
        d = super()._fingerprint_fields()
        h = hashlib.sha256()
        for tok, idx in sorted(self.encoder.items(), key=lambda kv: kv[1]):
            h.update(f"{tok}\x00{idx}\x01".encode())
        for (a, b), rank in sorted(self.bpe_ranks.items(), key=lambda kv: kv[1]):
            h.update(f"{a}\x00{b}\x00{rank}\x01".encode())
        d["vocab_sha"] = h.hexdigest()
        return d

    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.PAT, text):
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token_bytes).split(" ")
                       if t in self.encoder)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        text = raw.decode("utf-8", errors="replace").replace("</w>", " ")
        for special in ("<|startoftext|>", "<|endoftext|>"):
            text = text.replace(special, "")
        return text.strip()


# ---------------------------------------------------------------------------
# Hash tokenizer (offline fallback, deterministic)
# ---------------------------------------------------------------------------

class HashTokenizer(TokenizerBase):
    """Deterministic word-hash tokenizer. Not linguistically meaningful, but
    stable across runs/processes, reversible for ids it produced (keeps the
    instancelevel_random decode→re-encode loop consistent), and adequate for
    tests and CPU smoke training."""

    def __init__(self, vocab_size: int = 49408, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = 0
        self._reserved = {0, self.bos_token_id, self.eos_token_id}
        self._id_to_word: dict[int, str] = {}

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.sha256(word.lower().encode()).digest()[:8], "little")
        wid = 1 + h % (self.vocab_size - 3)  # skip pad/bos/eos
        self._id_to_word.setdefault(wid, word.lower())
        return wid

    def encode(self, text: str) -> list[int]:
        return [self._word_id(w) for w in _whitespace_clean(text).split(" ") if w]

    def decode(self, ids: Sequence[int]) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i in self._reserved:
                continue
            words.append(self._id_to_word.get(i, f"tok{i}"))
        return " ".join(words)


def load_tokenizer(checkpoint_dir: str | Path | None = None,
                   vocab_size: int = 49408,
                   model_max_length: int = 77) -> TokenizerBase:
    """ClipBPETokenizer when vocab/merges files are present, else HashTokenizer."""
    if checkpoint_dir:
        d = Path(checkpoint_dir)
        for sub in (d, d / "tokenizer"):
            vocab, merges = sub / "vocab.json", sub / "merges.txt"
            if vocab.exists() and merges.exists():
                return ClipBPETokenizer(vocab, merges, model_max_length)
    return HashTokenizer(vocab_size, model_max_length)
