"""Native CLIP BPE tokenizer (host Python and numpy only).

A copy of the JAX package's ``models/diffusion/tokenizer.py``: byte-level
BPE over the snapshot's ``tokenizer/vocab.json`` + ``tokenizer/merges.txt``,
with CLIP's specifics — lowercasing, whitespace cleanup, the ``</w>`` word
suffix, and bos/eos/pad(=eos) framing. Matches
``transformers.CLIPTokenizer`` token ids (tests/test_diffusion.py builds
both from the same vocab files and compares).

Deviation: CLIP's own cleanup also runs ``ftfy.fix_text`` (mojibake
repair); without ftfy only ``html.unescape`` (applied twice, as CLIP does)
is performed. Identical for any well-formed prompt.
"""

from __future__ import annotations

import functools
import html
import json
import os
import re

import numpy as np

__all__ = ["ClipBpeTokenizer"]


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP byte -> printable-unicode table (reversible)."""
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


_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE | re.UNICODE)


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text)).strip()
    return re.sub(r"\s+", " ", text)


class ClipBpeTokenizer:
    """Callable with the (subset of the) transformers.CLIPTokenizer API the
    diffusion pipeline uses: ``tok(text, padding='max_length', max_length=N,
    truncation=True, return_tensors='np').input_ids``."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_id = self.encoder.get("<|startoftext|>")
        self.eos_id = self.encoder.get("<|endoftext|>")
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_pretrained(cls, path: str) -> "ClipBpeTokenizer":
        """Load from a tokenizer directory (vocab.json + merges.txt)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f.read().split("\n"):
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                parts = line.split()
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Text -> BPE ids (no bos/eos framing)."""
        ids: list[int] = []
        for tok in _PAT.findall(_clean(text).lower()):
            btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(btok):
                ids.append(self.encoder[piece])
        return ids

    def __call__(self, text, padding: str = "max_length",
                 max_length: int = 77, truncation: bool = True,
                 return_tensors: str = "np"):
        texts = [text] if isinstance(text, str) else list(text)
        rows = []
        for t in texts:
            ids = self.encode(t)
            if truncation:
                ids = ids[:max_length - 2]
            row = [self.bos_id] + ids + [self.eos_id]
            if padding == "max_length":
                row += [self.eos_id] * (max_length - len(row))  # pad = eos
            rows.append(row)
        arr = np.asarray(rows, dtype=np.int32)

        class _Out:
            input_ids = arr
        return _Out()
