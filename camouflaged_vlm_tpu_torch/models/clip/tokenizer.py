"""CLIP byte-pair-encoding tokenizer.

The port's copy of `camouflaged_vlm_tpu/models/clip/tokenizer.py` kept so that the port
imports nothing of the JAX package; the CPU tests hold the two to the same
results.

A clean-room implementation of the standard (public) OpenAI CLIP BPE scheme,
providing the same surface the reference uses
(the reference's `alpha_clip_rw/simple_tokenizer.py`,
`alpha_clip.tokenize` at the reference's `alpha_clip_rw/alpha_clip.py:223-263`):
lower-cased, whitespace-collapsed text, byte-level unicode mapping, merges
ranked by the bundled 16e6 vocab, word-final `</w>` markers, and 77-token
sequences wrapped in <|startoftext|>/<|endoftext|>.

The vocab archive (`assets/bpe_simple_vocab_16e6.txt.gz`) is the public
OpenAI CLIP data asset. Vocab size 49408 = 256 bytes + 256 byte</w> + 48894
merges + 2 specials.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULT_BPE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "bpe_simple_vocab_16e6.txt.gz",
)

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@functools.lru_cache()
def _byte_unicode_table() -> Dict[int, str]:
    """Map every byte to a printable unicode char (reversible, GPT-2 style)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    chars = printable[:]
    extra = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            chars.append(256 + extra)
            extra += 1
    return dict(zip(printable, (chr(c) for c in chars)))


# The canonical pattern uses \p{L}/\p{N} via the `regex` package; prefer that
# when available (exact unicode behaviour), else fall back to an ASCII class
# which is exact for this framework's class-name prompts.
try:
    import regex as _regex

    _WORD_PATTERN = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:
    _WORD_PATTERN = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        re.IGNORECASE,
    )


@functools.lru_cache()
def _cp1252_reverse() -> Dict[str, int]:
    """Chars that windows-1252 places in the 0x80-0x9F C1 range -> byte."""
    table: Dict[str, int] = {}
    for b in range(0x80, 0xA0):
        try:
            table[bytes([b]).decode("cp1252")] = b
        except UnicodeDecodeError:
            pass  # 0x81/0x8D/0x8F/0x90/0x9D are undefined in cp1252
    return table


def _fix_mojibake(text: str) -> str:
    """Repair UTF-8 text that was mis-decoded as latin-1/windows-1252.

    The core of ftfy.fix_text's encoding repair (the reference cleans with
    ftfy, `alpha_clip_rw/simple_tokenizer.py:50-53`): if every char fits a
    windows-1252 byte and those bytes form valid multi-byte UTF-8, the text
    is the classic mojibake signature ("Ã©" -> "é", "â€™" -> "’") and is
    re-decoded; iterated twice for doubly-corrupted input. Legitimate
    accented text ("café") does NOT form valid UTF-8 byte sequences and
    passes through untouched, as does anything containing chars outside
    latin-1/cp1252 (ftfy segments mixed text; prompts here are whole-string).
    """
    rev = _cp1252_reverse()
    for _ in range(2):
        if all(ord(c) < 0x80 for c in text):
            break
        buf = bytearray()
        for c in text:
            b = rev.get(c, ord(c))
            if b > 0xFF:
                return text  # non-latin char: not mojibake, leave alone
            buf.append(b)
        try:
            fixed = bytes(buf).decode("utf-8")
        except UnicodeDecodeError:
            break
        if fixed == text:
            break
        text = fixed
    return text


def _clean(text: str) -> str:
    # The reference cleans with ftfy.fix_text + double html.unescape
    # (`alpha_clip_rw/simple_tokenizer.py:50-58`). ftfy's lasting effects in
    # order: mojibake repair (_fix_mojibake above), entity unescape, NFC
    # composition — so NFC runs AFTER the unescapes here, composing marks
    # that arrive as html entities ("cafe&#769;") the same as precomposed
    # "café" before byte-level BPE.
    text = _fix_mojibake(text)
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFC", text)
    text = re.sub(r"\s+", " ", text.strip())
    return text.strip().lower()


class ClipTokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = _byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        # Header line + the standard 48894-merge slice used by CLIP.
        merge_lines = merge_lines[1 : 49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = [tuple(m.split()) for m in merge_lines]

        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [tok + "</w>" for tok in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        assert len(vocab) == VOCAB_SIZE

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._bpe_cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def _bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self.merge_ranks.get(p, float("inf")))
            if best not in self.merge_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == first
                    and parts[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        result = " ".join(parts)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _WORD_PATTERN.findall(_clean(text)):
            mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[part] for part in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts, context_length: int = CONTEXT_LENGTH, truncate: bool = False
) -> np.ndarray:
    """Texts -> (N, context_length) int32 with SOT/EOT framing."""
    if isinstance(texts, str):
        texts = [texts]
    tok = _default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [tok.sot] + tok.encode(text) + [tok.eot]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(
                    f"input is too long for context length {context_length}: {text!r}"
                )
            ids = ids[:context_length]
            ids[-1] = tok.eot
        out[row, : len(ids)] = ids
    return out
