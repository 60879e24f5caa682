"""RoBERTa (GPT-2 scheme) byte-level BPE tokenizer, standard library only
(``avion_tpu.data.roberta_tokenizer``).

The legacy EgoVLP text tower (``egonlq.egovlp``) needs RoBERTa input ids.
This module makes them from a local HuggingFace-format tokenizer
directory (``vocab.json`` and ``merges.txt``), so ``extract_features
--legacy`` runs from raw text.

The GPT-2 scheme differs from the CLIP BPE (``data.tokenizer``) at every
stage: no text cleaning and no lowercasing; a case-sensitive pre-split
whose pieces take ONE leading space (rendered as the ``Ġ`` byte symbol);
merges over raw byte symbols with no ``</w>`` marker; the specials
``<s>`` / ``<pad>`` / ``</s>`` / ``<unk>`` read from the vocabulary.

The JAX tokenizer pre-splits with the third-party ``regex`` package and
the pattern ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``; the GPU machine has no ``regex``.
:func:`_pre_split` is a scanner over ``unicodedata.category`` that gives
the same pieces, with ``data.tokenizer``'s Unicode ``White_Space`` set
for ``\\s`` (a letter is a code point of category ``L*``, a number one of
``N*``).  As there, code points that Python's Unicode database leaves
unassigned and the ``regex`` package's newer tables assign are the one
known difference.
"""

from __future__ import annotations

import functools
import json
import os.path as osp
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from avion_tpu_torch.data.tokenizer import _WS_SET, _byte_to_unicode

# the contractions, matched case-sensitively, first at every position
_CONTRACTION_RE = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d")


def _kind(ch: str) -> str:
    """'S' whitespace, 'L' letter, 'N' number, 'O' anything else."""
    if ch in _WS_SET:
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def _pre_split(text: str) -> List[str]:
    """The pieces ``regex.findall`` gives for GPT-2's pattern."""
    out: List[str] = []
    kinds = [_kind(ch) for ch in text]
    i, n = 0, len(text)
    while i < n:
        m = _CONTRACTION_RE.match(text, i)
        if m:
            out.append(m.group())
            i = m.end()
            continue
        # ` ?\p{L}+`, ` ?\p{N}+`, ` ?[^\s\p{L}\p{N}]+`: a run of one kind,
        # with one leading U+0020 taken along
        j = i + 1 if text[i] == " " and i + 1 < n and kinds[i + 1] != "S" \
            else i
        if kinds[j] != "S":
            kind = kinds[j]
            j += 1
            while j < n and kinds[j] == kind:
                j += 1
            out.append(text[i:j])
            i = j
            continue
        # `\s+(?!\S)|\s+`: a whitespace run, less its last character when
        # a non-space follows and the run is longer than one
        j = i + 1
        while j < n and kinds[j] == "S":
            j += 1
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


class ByteLevelBPE:
    """GPT-2-style byte-level BPE over an HF ``vocab.json`` +
    ``merges.txt`` pair."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]], unk_token: str = "<unk>"):
        self.encoder = dict(vocab)
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.unk_id = self.encoder.get(unk_token)
        self.cache: Dict[str, Tuple[str, ...]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPE":
        with open(osp.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(osp.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> Tuple[str, ...]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
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
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _pre_split(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                i = self.encoder.get(piece, self.unk_id)
                if i is None:
                    raise KeyError(f"token {piece!r} not in vocab and no "
                                   "<unk> defined")
                ids.append(i)
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace")


class RobertaTokenizer:
    """``<s> ids </s>`` framing, right padding and the attention mask,
    called as a HuggingFace tokenizer is by ``egonlq.egovlp.
    EgoVLPFeatureExtractor`` (numpy arrays under ``input_ids`` and
    ``attention_mask``)."""

    def __init__(self, bpe: ByteLevelBPE,
                 bos_token: str = "<s>", eos_token: str = "</s>",
                 pad_token: str = "<pad>", model_max_length: int = 512):
        self.bpe = bpe
        self.bos_id = bpe.encoder[bos_token]
        self.eos_id = bpe.encoder[eos_token]
        self.pad_id = bpe.encoder[pad_token]
        # always-on truncation ceiling (roberta-base's 512): the position
        # table has max_positions rows, and a longer query must not index
        # past it
        self.model_max_length = model_max_length

    @classmethod
    def from_dir(cls, path: str) -> "RobertaTokenizer":
        return cls(ByteLevelBPE.from_dir(path))

    def __call__(self, texts, max_length: Optional[int] = None,
                 padding: bool = True, return_tensors: str = "np"):
        if return_tensors != "np":  # HF-call compatibility; numpy only
            raise ValueError("only return_tensors='np' is supported")
        if not padding:  # one rectangular ndarray is the only output
            raise ValueError("only padding=True is supported")
        if isinstance(texts, str):
            texts = [texts]
        rows = [[self.bos_id] + self.bpe.encode(t) + [self.eos_id]
                for t in texts]
        cap = min(max_length or self.model_max_length,
                  self.model_max_length)
        rows = [r[: cap - 1] + [self.eos_id] if len(r) > cap else r
                for r in rows]
        width = max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_id, np.int32)
        mask = np.zeros_like(ids)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@functools.lru_cache()
def load_roberta_tokenizer(path: str) -> RobertaTokenizer:
    """A RoBERTa tokenizer from a local HF-format directory
    (``vocab.json`` + ``merges.txt``)."""
    if not osp.isfile(osp.join(path, "vocab.json")):
        raise FileNotFoundError(
            f"no vocab.json under {path}: pass a local HF tokenizer "
            "directory (e.g. a downloaded roberta-base snapshot)")
    return RobertaTokenizer.from_dir(path)
