"""CLIP BPE tokenizer (self-contained; loads HF vocab.json + merges.txt). The
port's own copy of ``anyv2v_tpu/utils/tokenizer.py``.

The reference tokenizes prompts with transformers' ``CLIPTokenizer``
(``pipeline_i2vgen_xl.py:224`` ``encode_prompt`` pads/truncates to 77). This
is a from-scratch implementation of the standard CLIP byte-level BPE so the
framework has no tokenizer dependency at runtime; it reads the same
``vocab.json``/``merges.txt`` files that ship with every SD-family checkpoint.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import re
from typing import Dict, List, Optional, Tuple

import numpy as np


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte <-> unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
) if hasattr(re, "UNICODE") and False else re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-level BPE with CLIP's ``</w>`` end-of-word convention."""

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77):
        with open(vocab_path) as f:
            self.encoder: Dict[str, int] = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        # first line is the version header
        merges = [tuple(line.split()) for line in lines[1:] if len(line.split()) == 2]
        self.bpe_ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos = self.encoder.get("<|startoftext|>", 49406)
        self.eos = self.encoder.get("<|endoftext|>", 49407)
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token))
        return ids

    def __call__(self, texts, padding: str = "max_length") -> np.ndarray:
        """Pad/truncate to ``max_length`` with BOS/EOS like transformers'
        CLIPTokenizer(padding='max_length', truncation=True). CLIP pads with
        EOS (pad_token == eos for SD checkpoints)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.eos, np.int64)
        for i, text in enumerate(texts):
            ids = [self.bos] + self.encode(text)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out
