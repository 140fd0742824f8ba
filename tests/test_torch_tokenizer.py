"""The port's tokenizer, which needs no ``regex`` package, is token-exact
against the JAX package's (which splits with ``regex``)."""

import numpy as np
import pytest

from vitlens_tpu.data.processors import TextProcessor as JaxTextProcessor
from vitlens_tpu.text import tokenizer as JT
from vitlens_tpu_torch.data.processors import TextProcessor
from vitlens_tpu_torch.text import tokenizer as PT
from tests.test_torch_threads import share_cores

share_cores()

CAPTIONS = [
    "a dog barking in the distance",
    "Crème brûlée à la façon de Sébastien, naïve café",
    "东京的雨夜，电车驶过。日本語のテキストとカタカナ",
    "한국어 문장과 숫자 ²³ Ⅻ ⅷ ½ ٣ ४२",
    "emoji 🎸🔥👍🏽 and flags 🇯🇵 mixed—in text…",
    "it's what they'll say: we're sure you've I'm he'd",
    "IT'S LOUD, THEY'LL SHOUT",
    "tabs\tand\nnewlines   and  spaces",
    "cafÃ© donâ€™t — mojibake &amp; html &lt;tags&gt;",
    "Ｆｕｌｌｗｉｄｔｈ ﬁ ligature “quotes” ‘single’",
    "greek ᾳ with ypogegrammeni xͅy and ǅ titlecase",
    " ".join(["a very long caption that keeps going"] * 30),
    "",
]


@pytest.fixture(scope="module")
def tokenizers():
    return JT.SimpleTokenizer(), PT.SimpleTokenizer()


@pytest.mark.parametrize("caption", CAPTIONS)
def test_token_exact(tokenizers, caption):
    jax_tok, port_tok = tokenizers
    assert port_tok.encode(caption) == jax_tok.encode(caption)
    np.testing.assert_array_equal(port_tok(caption), jax_tok(caption))


def test_batch_and_text_processor_exact():
    want = JaxTextProcessor(tokenizer=JT.SimpleTokenizer())(CAPTIONS)
    got = TextProcessor()(CAPTIONS)
    assert got.shape == (len(CAPTIONS), 77) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # over-long input: truncated to 77 with EOT kept last
    assert PT.SimpleTokenizer()(CAPTIONS[-2])[0, -1] == 49407


def test_split_pattern_uses_stdlib_re():
    import re

    assert isinstance(PT._bpe_split_pattern(), re.Pattern)
    assert PT._bpe_split_pattern().findall("ab12 'll?!") == [
        "ab", "1", "2", "'ll", "?!"]
