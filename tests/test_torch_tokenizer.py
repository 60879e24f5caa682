"""The port's stdlib tokenizer against ``avion_tpu.data.tokenizer``
(which pre-splits with the ``regex`` package): ids must be equal."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from avion_tpu.data.tokenizer import tokenize as jax_tokenize
from avion_tpu_torch.data.tokenizer import tokenize

CORPUS = [
    "a person cuts an onion", "#C C opens the fridge's door",
    "#C C picks up the knife with his left hand", "",
    "It's 5 o'clock!! We'll go, they've gone, I'm here, you'd see",
    "IT'S LOUD", "'ſ and 'ſtartoftext", "<|startoftext|>hi<|endoftext|>",
    "naïve café — “quoted” ‘single’ ﬁne ﬂour", "ＡＢＣ　１２３ full width",
    "Ⅻ ½ ³ x² ٣ ① digits", "abͅcd ypogegrammeni",
    "x\x1cy\x1dz\x1e\x1f separators", "tab\tnew\nline sep　ideo",
    "ÃƒÂ©t double mojibake", "caf&eacute; &amp; html", "日本語のテキスト",
    "emoji 🙂👍🏽 and symbols ©®™", "a" * 300,
]


@pytest.mark.parametrize("text", CORPUS)
def test_corpus_ids_equal(text):
    np.testing.assert_array_equal(tokenize(text), jax_tokenize(text))


def test_batch_and_context_length():
    got = tokenize(CORPUS, context_length=13)
    assert got.shape == (len(CORPUS), 13) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_tokenize(CORPUS, 13))


# Unassigned code points (Cn) are left out: the ``regex`` package's
# Unicode tables assign some that Python's database does not, and there
# the two tokenizers may split differently.
@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.text(alphabet=st.characters(exclude_categories=("Cs", "Cn")),
               max_size=40))
def test_random_text_ids_equal(text):
    np.testing.assert_array_equal(tokenize(text), jax_tokenize(text))
