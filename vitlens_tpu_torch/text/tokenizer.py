"""CLIP byte-pair-encoding tokenizer (vocab 49408, context 77).

Token-exact copy of vitlens_tpu/text/tokenizer.py's ``SimpleTokenizer`` that
needs no ``regex`` package: the BPE split pattern's letter and number
classes (``\\p{L}``, ``\\p{N}``) are built once from ``unicodedata``
categories and compiled with the standard library's ``re``. The merge table
is read from $VITLENS_BPE_PATH or else from the port's own copy,
``vitlens_tpu_torch/text/bpe_simple_vocab_16e6.txt.gz`` (the public OpenAI
CLIP data file).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

_DEFAULT_PATHS = [
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "bpe_simple_vocab_16e6.txt.gz"),
]

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
CONTEXT_LENGTH = 77


def find_vocab_file() -> str:
    cand = [os.environ.get("VITLENS_BPE_PATH", "")] + _DEFAULT_PATHS
    for p in cand:
        if p and os.path.exists(p):
            return p
    raise FileNotFoundError(
        "CLIP BPE vocab not found; set VITLENS_BPE_PATH to "
        "bpe_simple_vocab_16e6.txt.gz"
    )


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 scheme)."""
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


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _byte_char(b: int) -> str:
    """The character byte `b` shows up as after a cp1252 mis-decode
    (latin-1 for the five bytes cp1252 leaves undefined — Python's strict
    cp1252 raises where ftfy's sloppy-windows-1252 falls through)."""
    try:
        return bytes([b]).decode("cp1252")
    except UnicodeDecodeError:
        return chr(b)


def _cls(lo: int, hi: int) -> str:
    return "".join(re.escape(_byte_char(b)) for b in range(lo, hi + 1))


# character classes of mis-decoded UTF-8 lead/continuation bytes.
# Continuations cover BOTH mis-decodes: cp1252 (0x80-0x9F as punctuation)
# and latin-1 (the same bytes as raw C1 controls) — ftfy's sloppy codecs
# accept both spellings too.
_LEAD2, _LEAD3, _LEAD4 = _cls(0xC2, 0xDF), _cls(0xE0, 0xEF), _cls(0xF0, 0xF4)
_CONT = "".join(re.escape(c) for c in sorted(
    {_byte_char(b) for b in range(0x80, 0xC0)}
    | {chr(b) for b in range(0x80, 0xA0)}))
# one or more adjacent mojibaked UTF-8 sequences embedded in otherwise-fine
# text (ftfy UTF8_DETECTOR_RE / decode_inconsistent_utf8, fixes.py)
_UTF8_SEQ_RE = re.compile(
    f"(?:[{_LEAD2}][{_CONT}]"
    f"|[{_LEAD3}][{_CONT}]{{2}}"
    f"|[{_LEAD4}][{_CONT}]{{3}})+")
# characters that appear when UTF-8 multi-byte sequences are mis-decoded as
# cp1252/latin-1 — every possible mis-decoded lead byte
_MOJIBAKE_HINTS = frozenset(_byte_char(b) for b in range(0xC2, 0xF5))

# ftfy restore_byte_a0 (fixes.py): a mojibaked NBSP (the 0xA0 continuation
# byte) is very often squashed to a plain space by later whitespace
# cleanup; restore it inside would-be UTF-8 sequences before re-decoding.
# Lead-byte set per ftfy chardata.ALTERED_UTF8_RE (the leads whose
# codepoints actually pair with 0xA0).
_ALTERED_UTF8_RE = re.compile(
    b"[\xc2\xc3\xc5\xce\xd0\xd9] "
    b"|[\xe0-\xef](?: [\x80-\xbf]|[\x80-\xbf] )"
    b"|[\xf0-\xf4](?: [\x80-\xbf]{2}|[\x80-\xbf] [\x80-\xbf]"
    b"|[\x80-\xbf]{2} )")

# ftfy replace_lossy_sequences (conservative subset): a mojibake lead char
# directly followed by U+FFFD means a continuation byte was already lost
# to a lossy decode — the sequence is unrecoverable, collapse it to one
# replacement char. (ftfy also treats '?' as a loss marker under its
# badness model; '?' is too common in real captions to risk here.)
_LOSSY_SEQ_RE = re.compile(f"[{_LEAD2}{_LEAD3}{_LEAD4}][{_CONT}]{{0,2}}�+")


def _restore_byte_a0(byts: bytes) -> bytes:
    return _ALTERED_UTF8_RE.sub(
        lambda m: m.group(0).replace(b" ", b"\xa0"), byts)


# -- mini badness model (the role of ftfy badness.py) ----------------------
# The shrink rule alone has false positives: "weiß\xa0nicht" encodes to
# cp1252 bytes whose 0xDF 0xA0 decodes as U+07E0 (an NKo letter) — shorter,
# but garbage spliced into a German word. ftfy rejects such repairs with a
# badness model; this is a compact equivalent: genuine mojibake carries
# UTF-8-shaped signatures (lead+continuation runs, squashed-NBSP "Ã "
# patterns), while a false repair splices rare-script letters into words of
# another script. A repair is accepted only when it strictly REDUCES
# badness (in addition to shrinking).
_A0_SQUASH_HINT_RE = re.compile(
    "[\xc2\xc3\xc5\xce\xd0\xd9] "
    f"|[{_LEAD3}](?: [{_CONT}]|[{_CONT}] )"
    f"|[{_LEAD4}](?: [{_CONT}]{{2}}|[{_CONT}] [{_CONT}]|[{_CONT}]{{2}} )")


def _letter_class(ch: str):
    """Coarse script class for letters (None for non-letters). Han+kana
    merge (Japanese words mix them); unlisted scripts fall back to their
    128-codepoint block so different rare scripts never merge."""
    if not unicodedata.category(ch).startswith("L"):
        return None
    o = ord(ch)
    if o <= 0x02AF or 0x1E00 <= o <= 0x1EFF or 0x2C60 <= o <= 0x2C7F:
        return "latin"
    if 0x0370 <= o <= 0x03FF or 0x1F00 <= o <= 0x1FFF:
        return "greek"
    if 0x0400 <= o <= 0x052F:
        return "cyrillic"
    if (0x2E80 <= o <= 0x9FFF and not 0x3130 <= o <= 0x318F) \
            or 0xF900 <= o <= 0xFAFF:
        return "ja"
    if 0xAC00 <= o <= 0xD7AF or 0x1100 <= o <= 0x11FF \
            or 0x3130 <= o <= 0x318F:
        return "hangul"
    return o >> 7


def _badness(text: str) -> int:
    score = 0
    for m in _UTF8_SEQ_RE.finditer(text):
        score += len(m.group(0))  # mojibake signature, weighted by length
    score += len(_A0_SQUASH_HINT_RE.findall(text))
    prev = None
    for ch in text:
        cls = _letter_class(ch)
        if cls is not None:
            o = ord(ch)
            # letters from scripts that essentially never appear in caption
            # corpora (Syriac/Thaana/NKo/Samaritan/Mandaic) — the classic
            # false-repair output of 0xDC-0xDF leads
            if 0x0700 <= o <= 0x074F or 0x0780 <= o <= 0x085F:
                score += 2
            # a letter spliced directly against a letter of another script
            if prev is not None and cls != prev:
                score += 1
        prev = cls
    return score


def _decode_inconsistent_utf8(text: str) -> str:
    """ftfy decode_inconsistent_utf8: when the WHOLE string cannot round-
    trip (mixed content — e.g. real emoji next to mojibake), re-decode just
    the embedded UTF-8-shaped runs. Same shrink-validated acceptance as the
    full-string path."""

    def fix_one(m: re.Match) -> str:
        sub = m.group(0)
        for enc in ("cp1252", "latin-1"):
            try:
                byts = sub.encode(enc)
            except UnicodeEncodeError:
                continue
            try:
                return byts.decode("utf-8")
            except UnicodeDecodeError:
                continue
        return sub

    return _UTF8_SEQ_RE.sub(fix_one, text)


def _fix_mojibake(text: str) -> str:
    """The core ftfy.fix_text repair: UTF-8 bytes that were decoded as
    cp1252/latin-1 ("cafÃ©" -> "café", "donâ€™t" -> "don’t"). Applied up to
    3x (mojibake nests); a candidate is accepted only when the re-decode
    succeeds AND strictly shrinks the text AND strictly reduces `_badness`
    — shrinking alone misfires on e.g. "weiß\\xa0nicht" (0xDF 0xA0 is a
    valid-but-garbage NKo codepoint); the badness model rejects repairs
    that splice rare-script letters into another script's words.
    Deeper ftfy heuristics layered on the same acceptance rule:
    restore_byte_a0 (squashed NBSP continuation bytes), and
    decode_inconsistent_utf8 (per-run repair when mixed content blocks the
    whole-string round-trip)."""
    for _ in range(3):
        if not any(c in _MOJIBAKE_HINTS for c in text):
            return text
        fixed = None
        for enc in ("cp1252", "latin-1"):
            try:
                byts = text.encode(enc)
            except UnicodeEncodeError:
                continue
            for cand in (byts, _restore_byte_a0(byts)):
                try:
                    f = cand.decode("utf-8")
                except UnicodeDecodeError:
                    continue
                if len(f) < len(text) and _badness(f) < _badness(text):
                    fixed = f
                break
            if fixed is not None:
                break
        if fixed is None:
            # whole-string round-trip impossible or rejected: repair
            # embedded runs individually (mixed mojibake + real unicode),
            # under the same badness acceptance
            fixed = _decode_inconsistent_utf8(text)
            if fixed == text or _badness(fixed) >= _badness(text):
                return text
        text = fixed
    return text


# ftfy's remove_control_chars set: C0/C1 controls EXCEPT the whitespace
# ones ftfy keeps (\t \n \f \r), plus the zero-width BOM U+FEFF
_CONTROL_CHARS = frozenset(
    c for c in map(chr, list(range(32)) + list(range(0x7F, 0xA0)))
    if c not in "\t\n\f\r") | {"\ufeff"}

_TERMINAL_ESCAPE_RE = re.compile(r"\x1b\[(?:\d|;)*[a-zA-Z]")
# uncurl_quotes: typographic single/double quotes -> ASCII
_SINGLE_QUOTE_RE = re.compile("[\u2018-\u201b]")
_DOUBLE_QUOTE_RE = re.compile("[\u201c-\u201f]")
# fix_surrogates: UTF-16 surrogate pairs leaked into a str (bad JSON/cesu8)
_SURROGATE_PAIR_RE = re.compile(r"[\ud800-\udbff][\udc00-\udfff]")
_LONE_SURROGATE_RE = re.compile(r"[\ud800-\udfff]")


def _build_width_map() -> dict:
    """fix_character_width translate table: fullwidth forms -> ASCII,
    halfwidth katakana/jamo -> standard width (per-char NFKC over the
    Halfwidth and Fullwidth Forms block), ideographic space -> space, and
    the halfwidth voiced-sound marks -> COMBINING marks so the final NFC
    pass composes them onto the preceding kana (\uff8c\uff9e -> \u30d6)."""
    width_map = {}
    for i in range(0xFF01, 0xFFF0):
        alt = unicodedata.normalize("NFKC", chr(i))
        if alt != chr(i):
            width_map[i] = alt
    width_map[0x3000] = " "
    width_map[0xFF9E] = "\u3099"  # combining voiced sound mark
    width_map[0xFF9F] = "\u309a"  # combining semi-voiced sound mark
    return width_map


_WIDTH_MAP = _build_width_map()

# fix_latin_ligatures: the Latin ligature codepoints, expanded via NFKC
_LIGATURE_MAP = {ord(c): unicodedata.normalize("NFKC", c)
                 for c in "\u0132\u0133\ufb00\ufb01\ufb02\ufb03\ufb04\ufb05\ufb06"}

# fix_c1_controls: C1 control chars (U+0080-U+009F) are nearly always
# windows-1252 punctuation read through latin-1; re-decode the defined ones
_C1_MAP = {}
for _c1 in range(0x80, 0xA0):
    try:
        _C1_MAP[_c1] = bytes([_c1]).decode("cp1252")
    except UnicodeDecodeError:
        pass  # the 5 codes cp1252 leaves undefined stay as controls
del _c1


def _fix_surrogates(text: str) -> str:
    if not _LONE_SURROGATE_RE.search(text):
        return text
    text = _SURROGATE_PAIR_RE.sub(
        lambda m: chr(0x10000 + (ord(m.group(0)[0]) - 0xD800) * 0x400
                      + (ord(m.group(0)[1]) - 0xDC00)), text)
    return _LONE_SURROGATE_RE.sub("\ufffd", text)


def fix_text(text: str) -> str:
    """ftfy.fix_text with its default fixer set, in ftfy's order (the
    reference tokenizer.py:67-70 runs it before BPE; ftfy is not in this
    image): unescape_html, remove_terminal_escapes, fix_encoding (mojibake,
    above), fix_c1_controls, fix_latin_ligatures, fix_character_width,
    uncurl_quotes, fix_line_breaks, fix_surrogates, remove_control_chars,
    NFC normalization."""
    if "&" in text:
        text = html.unescape(text)
    if "\x1b" in text:
        text = _TERMINAL_ESCAPE_RE.sub("", text)
    text = _fix_mojibake(text)
    if "�" in text:
        text = _LOSSY_SEQ_RE.sub("�", text)
    text = text.translate(_C1_MAP).translate(_LIGATURE_MAP)
    text = text.translate(_WIDTH_MAP)
    text = _SINGLE_QUOTE_RE.sub("'", _DOUBLE_QUOTE_RE.sub('"', text))
    text = text.replace("\r\n", "\n")
    for lb in ("\r", "\u2028", "\u2029"):
        if lb in text:
            text = text.replace(lb, "\n")
    text = _fix_surrogates(text)
    if any(c in _CONTROL_CHARS for c in text):
        text = "".join(c for c in text if c not in _CONTROL_CHARS)
    return unicodedata.normalize("NFC", text)


def _basic_clean(text: str) -> str:
    # reference basic_clean (tokenizer.py:67-70): ftfy.fix_text + an
    # explicit double html-unescape on top + strip
    return html.unescape(html.unescape(fix_text(text))).strip()


def _class_ranges(pred) -> str:
    """A regex character-class body holding every code point for which
    ``pred`` is true, written as escaped ranges."""
    parts, start = [], None
    for c in range(sys.maxunicode + 2):
        hit = c <= sys.maxunicode and pred(c)
        if hit and start is None:
            start = c
        elif not hit and start is not None:
            lo, hi = re.escape(chr(start)), re.escape(chr(c - 1))
            parts.append(lo if start == c - 1 else f"{lo}-{hi}")
            start = None
    return "".join(parts)


@functools.lru_cache(maxsize=None)
def _bpe_split_pattern() -> "re.Pattern[str]":
    """Stdlib ``re`` form of the CLIP split pattern

        <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
        [\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+        (regex module, IGNORECASE)

    The classes are matched case-sensitively: under IGNORECASE the stdlib
    would let U+0345 (which folds to a Greek letter) into the letter class,
    where ``regex`` leaves it out of both the letter class and the negated
    class. ``regex``'s ``\\s`` also leaves out U+001C-U+001F, which the
    stdlib's matches. Both are written out here so the two split alike."""
    cats = [unicodedata.category(chr(c)) for c in range(sys.maxunicode + 1)]
    letters = _class_ranges(lambda c: cats[c][0] == "L")
    numbers = _class_ranges(lambda c: cats[c][0] == "N")
    space = _class_ranges(
        lambda c: chr(c).isspace() and not 0x1C <= c <= 0x1F)
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        f"(?-i:[{letters}]+|[{numbers}]|[^{space}{letters}{numbers}\u0345]+)",
        re.IGNORECASE,
    )


class SimpleTokenizer:
    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or find_vocab_file()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        merge_lines = merge_lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines]

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend([SOT_TEXT, EOT_TEXT])

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.pat = _bpe_split_pattern()
        self.sot_token = self.encoder[SOT_TEXT]
        self.eot_token = self.encoder[EOT_TEXT]
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = CONTEXT_LENGTH,
    ) -> np.ndarray:
        """Tokenize to [N, context_length] int32 with SOT/EOT; long inputs
        are truncated keeping EOT as the final token (reference
        tokenizer.py:177-208)."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(toks) > context_length:
                toks = toks[:context_length]
                toks[-1] = self.eot_token
            result[i, : len(toks)] = toks
        return result


class HFTokenizer:
    """The hf-text archs' tokenizer (reference open_clip HFTokenizer):
    transformers' AutoTokenizer, padded and truncated to the context length.
    ``name_or_path`` is a local save_pretrained directory, or a hub name whose
    files are already in the local cache; transformers is imported here,
    at construction."""

    def __init__(self, name_or_path: str):
        try:
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(name_or_path)
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(
                f"could not load HF tokenizer {name_or_path!r}: hf-text "
                "archs need the tokenizer files locally (set the name to a "
                "local save_pretrained directory in offline environments)"
            ) from e

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        # the reference HFTokenizer cleans before tokenizing
        texts = [_whitespace_clean(_basic_clean(t)) for t in texts]
        out = self.tokenizer(list(texts), padding="max_length", truncation=True,
                             max_length=context_length, return_tensors="np")
        return out["input_ids"].astype(np.int32)


@functools.lru_cache()
def get_tokenizer(vocab_path: str | None = None,
                  hf_tokenizer_name: str | None = None):
    """CLIP BPE by default; the HF wrapper when the model's TextArch names
    an hf tokenizer."""
    if hf_tokenizer_name:
        return HFTokenizer(hf_tokenizer_name)
    return SimpleTokenizer(vocab_path)


def tokenize(texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    return get_tokenizer()(texts, context_length)
