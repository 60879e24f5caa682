"""The port's RoBERTa byte-level BPE (``avion_tpu_torch.data.
roberta_tokenizer``, standard library only) against ``avion_tpu.data.
roberta_tokenizer`` (which pre-splits with the ``regex`` package) on a
made-up HF-format vocabulary, built as ``tests/test_roberta_tokenizer.py``
builds it: the pre-split pieces, the ids, the batch call's ids, masks and
truncation exactly, on fixed texts and on ``hypothesis`` strings over
letters, numbers, marks, whitespace and contractions."""

import json
import os.path as osp

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from avion_tpu.data import roberta_tokenizer as jrt
from avion_tpu_torch.data import roberta_tokenizer as prt
from avion_tpu_torch.data.tokenizer import _byte_to_unicode

TEXTS = [
    "the cat sat on the mat",
    "Hello, World!  It's the THE the...",
    "a",
    "",
    " leading space and trailing ",
    "café naïve ☕",
    "don't it's we're I'll they'd you've I'm",
    "DON'T IT'S 'S 'sup ''s",
    "tabs\tand\nnewlines  collapse?",
    "1234 56.78 9 ½ Ⅻ ٣",
    "  \n x\t\ty\u00a0 z\u2003 \u3000end   ",
    "é ño combining marks",
    "where did I put the knife after I cut the onion?",
]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """Specials at ids 0-4, all 256 byte symbols, and a small merge table
    whose products are all in the vocabulary."""
    d = tmp_path_factory.mktemp("roberta_tok")
    merges = [
        ("t", "h"), ("th", "e"), ("Ġ", "t"), ("Ġt", "he"), ("Ġ", "a"),
        ("a", "t"), ("Ġ", "c"), ("Ġc", "at"), ("Ġ", "s"), ("Ġs", "at"),
        ("Ġ", "m"), ("Ġm", "at"), ("o", "n"), ("Ġ", "on"), ("l", "l"),
        ("e", "ll"), ("H", "ell"), ("Hell", "o"), ("Ġ", "W"), ("o", "r"),
        ("l", "d"), ("or", "ld"), ("ĠW", "orld"), ("'", "s"), ("'", "t"),
        ("Ġ", "i"), ("Ġi", "t"), ("e", "s"), ("Ġ", "n"), ("1", "2"),
        ("12", "3"), ("Ġ", "5"), ("Ġ5", "6"), (".", "."), ("..", "."),
        ("Ċ", "Ċ"), ("Ġ", "Ġ"), ("ĠĠ", "ĠĠ"), ("Ġ", "k"), ("n", "i"),
        ("Ġk", "ni"), ("Ġkni", "f"), ("Ġknif", "e"),
    ]
    vocab = {}
    for s in ("<s>", "<pad>", "</s>", "<unk>", "<mask>"):
        vocab[s] = len(vocab)
    for ch in _byte_to_unicode().values():
        vocab[ch] = len(vocab)
    for a, b in merges:
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
    with open(osp.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(osp.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.write("\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return str(d)


@pytest.fixture(scope="module")
def pair(tok_dir):
    return prt.ByteLevelBPE.from_dir(tok_dir), jrt.ByteLevelBPE.from_dir(
        tok_dir)


def _check(text, pair):
    ours, ref = pair
    assert prt._pre_split(text) == jrt.re.findall(jrt._GPT2_PAT, text), text
    assert ours.encode(text) == ref.encode(text), text


@pytest.mark.parametrize("text", TEXTS)
def test_pieces_and_ids_match_jax(text, pair):
    _check(text, pair)
    ours, _ = pair
    assert ours.decode(ours.encode(text)) == text


# letters, numbers, marks, spaces of several kinds, apostrophes and
# punctuation; Python's Unicode tables and the regex package's agree on
# what they assign in these categories below U+3000
_CHARS = st.characters(
    categories=("Lu", "Ll", "Lt", "Lm", "Lo", "Nd", "Nl", "No", "Mn", "Mc",
                "Me", "Zs", "Po", "Sm", "So"),
    max_codepoint=0x2FFF)
_PIECES = st.sampled_from(["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'",
                           "'S", " ", "  ", "\t", "\n", "\r\n", "\x0b",
                           "\x1c", "\x85", "\u00a0", "\u2009", "\u3000"])


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(_CHARS, _PIECES), max_size=24).map("".join))
def test_random_strings_match_jax(pair, text):
    _check(text, pair)


def test_batch_call_padding_and_truncation_match_jax(tok_dir):
    ours = prt.RobertaTokenizer.from_dir(tok_dir)
    ref = jrt.RobertaTokenizer.from_dir(tok_dir)
    for kw in ({}, {"max_length": 6}, {"max_length": 3}):
        got, want = ours(TEXTS, **kw), ref(TEXTS, **kw)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == np.int32
    enc = ours(["the cat", ""])
    assert enc["input_ids"][1, 1] == 2 and (enc["input_ids"][1, 2:] == 1).all()
    with pytest.raises(ValueError):
        ours(TEXTS, return_tensors="pt")
    with pytest.raises(ValueError):
        ours(TEXTS, padding=False)


def test_unknown_byte_maps_to_unk_and_missing_dir(tmp_path):
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in "abc":
        vocab[ch] = len(vocab)
    assert prt.ByteLevelBPE(vocab, []).encode("abz") == [4, 5, 3]
    with pytest.raises(FileNotFoundError):
        prt.load_roberta_tokenizer(str(tmp_path))
