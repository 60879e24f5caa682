"""CLIP byte-level BPE tokenizer, standard library only.

The port's own copy of ``avion_tpu.data.tokenizer``: byte->unicode remap,
greedy lowest-rank pair merging over the 16e6 merge table,
``<|startoftext|>`` / ``<|endoftext|>`` specials, a fixed 77-token
context with truncation that keeps EOT in the last slot, and the same
deterministic subset of ``ftfy.fix_text``.  Output is numpy int32;
``SimpleTokenizer.decode`` turns ids back into text.

The JAX tokenizer pre-splits with the third-party ``regex`` package
(``\\p{L}``, ``\\p{N}``, its own ``\\s``, IGNORECASE), which the GPU
machine does not have.  ``_pre_split`` is a scanner over
``unicodedata.category`` that gives the same pieces:

- a letter is a code point of category ``L*``, a number one of ``N*``;
  ``[^\\W\\d_]`` is not a substitute, because Python's ``\\w`` also takes
  ``No`` / ``Nl`` characters;
- whitespace is the Unicode ``White_Space`` set that ``regex`` uses for
  ``\\s`` (Python's ``str.isspace`` adds U+001C..U+001F);
- the literal alternatives (specials, contractions) match case-blind,
  as ``regex`` does (``'ſ`` is the contraction ``'s``);
- U+0345 case-folds to a letter, so under IGNORECASE ``regex`` takes it
  as neither a letter nor a non-letter and drops it.

Code points that Python's Unicode database leaves unassigned but the
``regex`` package's newer tables assign are the one known difference.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import List, Union

import numpy as np

_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                      "bpe_simple_vocab_16e6.txt.gz")

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
CONTEXT_LENGTH = 77

# Unicode White_Space: what the ``regex`` package's \s matches
_WS_CHARS = ("\t\n\x0b\x0c\r \x85\xa0\u1680"
             + "".join(map(chr, range(0x2000, 0x200B)))
             + "\u2028\u2029\u202f\u205f\u3000")
_WS_SET = frozenset(_WS_CHARS)
_WS_RUN_RE = re.compile("[" + re.escape(_WS_CHARS) + "]+")
_LITERAL_RE = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d""",
    re.IGNORECASE)
_DROPPED = "\u0345"


@functools.lru_cache()
def _byte_to_unicode():
    """Reversible byte→printable-unicode map (standard GPT-2/CLIP trick)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapped = printable[:]
    offset = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            mapped.append(256 + offset)
            offset += 1
    return dict(zip(printable, (chr(c) for c in mapped)))


# ftfy.fixes.uncurl_quotes: curly single/double quotes -> ASCII
_SINGLE_QUOTE_RE = re.compile("[\u02bc\u2018-\u201b]")
_DOUBLE_QUOTE_RE = re.compile("[\u201c-\u201f]")
# ftfy.fixes.fix_latin_ligatures
_LIGATURES = str.maketrans({
    "\u0132": "IJ", "\u0133": "ij", "\ufb00": "ff", "\ufb01": "fi",
    "\ufb02": "fl", "\ufb03": "ffi", "\ufb04": "ffl", "\ufb05": "ft",
    "\ufb06": "st",
})


def _sloppy_cp1252_bytes(text: str) -> bytes:
    """Encode as windows-1252 with the latin-1 fallback ftfy's
    'sloppy-windows-1252' codec uses for the five undefined bytes."""
    out = bytearray()
    for ch in text:
        try:
            out += ch.encode("cp1252")
        except UnicodeEncodeError:
            o = ord(ch)
            if o > 0xFF:
                raise
            out.append(o)
    return bytes(out)


def _fix_mojibake(text: str) -> str:
    """Iteratively undo UTF-8 bytes mis-decoded as cp1252/latin-1."""
    for _ in range(3):
        if text.isascii():
            break
        try:
            fixed = _sloppy_cp1252_bytes(text).decode("utf-8")
        except (UnicodeEncodeError, UnicodeDecodeError):
            break
        if fixed == text:
            break
        text = fixed
    return text


def _fix_text(text: str) -> str:
    """The ftfy.fix_text default pipeline, deterministic subset."""
    text = _fix_mojibake(text)
    if "<" not in text and "&" in text:
        text = html.unescape(text)
    text = "".join(
        ch for ch in text
        if not (unicodedata.category(ch) == "Cc" and ch not in "\t\n\r\f")
    )
    text = text.translate(_LIGATURES)
    if any("\uff00" <= ch <= "\uffef" or ch == "\u3000" for ch in text):
        text = "".join(
            unicodedata.normalize("NFKC", ch)
            if ("\uff00" <= ch <= "\uffef" or ch == "\u3000") else ch
            for ch in text
        )
    text = _SINGLE_QUOTE_RE.sub("'", text)
    text = _DOUBLE_QUOTE_RE.sub('"', text)
    return unicodedata.normalize("NFC", text)


def _clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _WS_RUN_RE.sub(" ", text)
    return text.strip()


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, ' ' whitespace or dropped, 'O' other."""
    if ch in _WS_SET or ch == _DROPPED:
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def _pre_split(text: str) -> List[str]:
    """The pieces ``regex.findall`` gives for the JAX tokenizer's pattern
    ``specials|contractions|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        m = _LITERAL_RE.match(text, i)
        if m:
            out.append(m.group())
            i = m.end()
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    def __init__(self, bpe_path: str = _ASSET):
        self.byte_encoder = _byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path) as f:
            lines = f.read().decode("utf-8").split("\n")
        # first line is a version header; the table holds 48894 merges
        merges = [tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT_TOKEN, EOT_TOKEN]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.sot_token = self.encoder[SOT_TOKEN]
        self.eot_token = self.encoder[EOT_TOKEN]
        self.vocab_size = len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _clean(text).lower()
        for tok in _pre_split(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return tokens

    def decode(self, tokens) -> str:
        """Ids back to text: each word's ``</w>`` becomes a space."""
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


class BosEosIds:
    """A BPE with ``encode`` and ``eos_token_id`` (transformers'
    ``GPT2Tokenizer``) in :func:`tokenize`'s form: GPT-2's one id for the
    start and the end of a text first and last, padding 0 after, as
    LaViLa's ``MyGPT2Tokenizer`` (``add_bos``) writes a caption."""

    def __init__(self, bpe):
        self.bpe = bpe
        self.sot_token = self.eot_token = bpe.eos_token_id

    def encode(self, text: str) -> List[int]:
        return list(self.bpe.encode(text))


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = CONTEXT_LENGTH,
    tokenizer: SimpleTokenizer | None = None,
) -> np.ndarray:
    """Tokenize to a fixed-size [N, context_length] int32 array with
    SOT/EOT and truncation that keeps EOT in the last slot."""
    if isinstance(texts, str):
        texts = [texts]
        squeeze = True
    else:
        squeeze = False
    tk = tokenizer or _default_tokenizer()
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = [tk.sot_token] + tk.encode(text) + [tk.eot_token]
        if len(ids) > context_length:
            ids = ids[:context_length]
            ids[-1] = tk.eot_token
        out[i, : len(ids)] = ids
    return out[0] if squeeze else out
