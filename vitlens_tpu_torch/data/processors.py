"""Host-side processors (port of vitlens_tpu/data/processors.py).

Only ``TextProcessor`` is ported: caption cleanup plus CLIP BPE.
"""

from __future__ import annotations

import re

import numpy as np


def _wrap_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class TextProcessor:
    def __init__(self, prompt: str = "", max_words: int = 70,
                 context_length: int = 77, tokenizer=None):
        self.prompt = prompt
        self.max_words = max_words
        self.context_length = context_length
        if tokenizer is None:
            from vitlens_tpu_torch.text.tokenizer import get_tokenizer

            tokenizer = get_tokenizer()
        self.tokenizer = tokenizer

    def pre_caption(self, caption: str) -> str:
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return caption

    def __call__(self, captions) -> np.ndarray:
        caps = [self.prompt + self.pre_caption(c) for c in _wrap_list(captions)]
        return self.tokenizer(caps, self.context_length)
