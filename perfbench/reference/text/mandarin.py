"""Mandarin g2p: hanzi/pinyin -> bopomofo -> IPA (with tone arrows).

Behavioral reference: reference text/mandarin.py and text/paddle_zh.py.
The pinyin->bopomofo and bopomofo->IPA tables encode the standard Zhuyin /
IPA correspondences (same linguistic mapping as the reference; re-stated).

Both paths are dependency-free: the raw-pinyin [P] path is pure python, and
the full hanzi [ZH] path runs on the vendored lexicon + frontend in
vits_tpu.text.zh_frontend (jieba used for segmentation when present, with a
greedy lexicon fallback).
"""

from __future__ import annotations

import re

from perfbench.reference.text.numbers import an2cn

# -- pinyin -> bopomofo (standard Zhuyin correspondence table) --------------

_PRE_REPLACEMENTS = [
    ("yu", "u:"), ("ü", "u:"), ("v", "u:"),
    ("yi", "i"), ("you", "ㄧㄡ"), ("y", "i"),
    ("wu", "u"), ("wong", "ㄨㄥ"), ("w", "u"),
]

_TABLE = [
    # whole-syllable special cases
    ("ju", "ㄐㄩ"), ("qu", "ㄑㄩ"), ("xu", "ㄒㄩ"),
    ("zhi", "ㄓ"), ("chi", "ㄔ"), ("shi", "ㄕ"), ("ri", "ㄖ"),
    ("zi", "ㄗ"), ("ci", "ㄘ"), ("si", "ㄙ"),
    ("r5", "ㄦ"),
    # initials
    ("b", "ㄅ"), ("p", "ㄆ"), ("m", "ㄇ"), ("f", "ㄈ"),
    ("d", "ㄉ"), ("t", "ㄊ"), ("n", "ㄋ"), ("l", "ㄌ"),
    ("g", "ㄍ"), ("k", "ㄎ"), ("h", "ㄏ"),
    ("j", "ㄐ"), ("q", "ㄑ"), ("x", "ㄒ"),
    ("zh", "ㄓ"), ("ch", "ㄔ"), ("sh", "ㄕ"), ("r", "ㄖ"),
    ("z", "ㄗ"), ("c", "ㄘ"), ("s", "ㄙ"),
    # finals
    ("i", "ㄧ"), ("u", "ㄨ"), ("u:", "ㄩ"),
    ("a", "ㄚ"), ("o", "ㄛ"), ("e", "ㄜ"), ("ê", "ㄝ"),
    ("ai", "ㄞ"), ("ei", "ㄟ"), ("ao", "ㄠ"), ("ou", "ㄡ"),
    ("an", "ㄢ"), ("en", "ㄣ"), ("ang", "ㄤ"), ("eng", "ㄥ"),
    ("er", "ㄦ"),
    ("ia", "ㄧㄚ"), ("io", "ㄧㄛ"), ("ie", "ㄧㄝ"), ("iai", "ㄧㄞ"),
    ("iao", "ㄧㄠ"), ("iu", "ㄧㄡ"), ("ian", "ㄧㄢ"),
    ("in", "ㄧㄣ"), ("iang", "ㄧㄤ"), ("ing", "ㄧㄥ"),
    ("ua", "ㄨㄚ"), ("uo", "ㄨㄛ"), ("uai", "ㄨㄞ"),
    ("ui", "ㄨㄟ"), ("uan", "ㄨㄢ"), ("un", "ㄨㄣ"),
    ("uang", "ㄨㄤ"), ("ong", "ㄨㄥ"),
    ("u:e", "ㄩㄝ"), ("u:an", "ㄩㄢ"), ("u:n", "ㄩㄣ"), ("iong", "ㄩㄥ"),
    # tone digits -> tone marks
    ("1", "ˉ"), ("2", "ˊ"), ("3", "ˇ"), ("4", "ˋ"), ("5", "˙"),
]
_TABLE.sort(key=lambda p: len(p[0]), reverse=True)
_REPLACEMENTS = _PRE_REPLACEMENTS + _TABLE

# -- latin letters spelled in bopomofo (reference mandarin.py:8-35) ---------

_LATIN_TO_BOPOMOFO = [
    (re.compile(p, re.IGNORECASE), r)
    for p, r in [
        ("a", "ㄟˉ"), ("b", "ㄅㄧˋ"), ("c", "ㄙㄧˉ"), ("d", "ㄉㄧˋ"),
        ("e", "ㄧˋ"), ("f", "ㄝˊㄈㄨˋ"), ("g", "ㄐㄧˋ"), ("h", "ㄝˇㄑㄩˋ"),
        ("i", "ㄞˋ"), ("j", "ㄐㄟˋ"), ("k", "ㄎㄟˋ"), ("l", "ㄝˊㄛˋ"),
        ("m", "ㄝˊㄇㄨˋ"), ("n", "ㄣˉ"), ("o", "ㄡˉ"), ("p", "ㄆㄧˉ"),
        ("q", "ㄎㄧㄡˉ"), ("r", "ㄚˋ"), ("s", "ㄝˊㄙˋ"), ("t", "ㄊㄧˋ"),
        ("u", "ㄧㄡˉ"), ("v", "ㄨㄧˉ"), ("w", "ㄉㄚˋㄅㄨˋㄌㄧㄡˋ"),
        ("x", "ㄝˉㄎㄨˋㄙˋ"), ("y", "ㄨㄞˋ"), ("z", "ㄗㄟˋ"),
    ]
]

# -- bopomofo -> IPA (standard Zhuyin-IPA correspondence, VITS flavor) ------

_BOPOMOFO_TO_IPA = [
    (re.compile(p), r)
    for p, r in [
        ("ㄅㄛ", "p⁼wo"), ("ㄆㄛ", "pʰwo"), ("ㄇㄛ", "mwo"), ("ㄈㄛ", "fwo"),
        ("ㄅ", "p⁼"), ("ㄆ", "pʰ"), ("ㄇ", "m"), ("ㄈ", "f"),
        ("ㄉ", "t⁼"), ("ㄊ", "tʰ"), ("ㄋ", "n"), ("ㄌ", "l"),
        ("ㄍ", "k⁼"), ("ㄎ", "kʰ"), ("ㄏ", "x"),
        ("ㄐ", "tʃ⁼"), ("ㄑ", "tʃʰ"), ("ㄒ", "ʃ"),
        ("ㄓ", "ts`⁼"), ("ㄔ", "ts`ʰ"), ("ㄕ", "s`"), ("ㄖ", "ɹ`"),
        ("ㄗ", "ts⁼"), ("ㄘ", "tsʰ"), ("ㄙ", "s"),
        ("ㄚ", "a"), ("ㄛ", "o"), ("ㄜ", "ə"), ("ㄝ", "ɛ"),
        ("ㄞ", "aɪ"), ("ㄟ", "eɪ"), ("ㄠ", "ɑʊ"), ("ㄡ", "oʊ"),
        ("ㄧㄢ", "jɛn"), ("ㄩㄢ", "ɥæn"), ("ㄢ", "an"),
        ("ㄧㄣ", "in"), ("ㄩㄣ", "ɥn"), ("ㄣ", "ən"),
        ("ㄤ", "ɑŋ"), ("ㄧㄥ", "iŋ"), ("ㄨㄥ", "ʊŋ"), ("ㄩㄥ", "jʊŋ"),
        ("ㄥ", "əŋ"), ("ㄦ", "əɻ"),
        ("ㄧ", "i"), ("ㄨ", "u"), ("ㄩ", "ɥ"),
        ("ˉ", "→"), ("ˊ", "↑"), ("ˇ", "↓↑"), ("ˋ", "↓"), ("˙", ""),
        ("，", ","), ("。", "."), ("！", "!"), ("？", "?"), ("—", "-"),
    ]
]


def number_to_chinese(text: str) -> str:
    """Digits -> Chinese readings (reference mandarin.py:100-104)."""
    for number in re.findall(r"\d+(?:\.?\d+)?", text):
        text = text.replace(number, an2cn(number), 1)
    return text


def pu_symbol_replace(data: str) -> str:
    """CJK punctuation -> ASCII (reference paddle_zh.py:90-96)."""
    china_tab = ["！", "？", "…", "，", "。", "、", "..."]
    english_tab = ["!", "?", "…", ",", ".", ",", "…"]
    for c, e in zip(china_tab, english_tab):
        if c in data:
            data = data.replace(c, e)
    return data


def bopomofo(pinyin: str) -> str:
    """Tone-numbered pinyin -> bopomofo (reference paddle_zh.py:60-70)."""
    pinyin = pinyin.lower()
    for old, new in _REPLACEMENTS:
        pinyin = pinyin.replace(old, new)
    return pinyin


def latin_to_bopomofo(text: str) -> str:
    for regex, replacement in _LATIN_TO_BOPOMOFO:
        text = regex.sub(replacement, text)
    return text


def bopomofo_to_ipa(text: str) -> str:
    for regex, replacement in _BOPOMOFO_TO_IPA:
        text = regex.sub(replacement, text)
    return text


def _clean_zh(text: str) -> str:
    """Medial/retroflex rewrites (reference mandarin.py:133-140)."""
    text = latin_to_bopomofo(text)
    text = bopomofo_to_ipa(text)
    text = re.sub("i([aoe])", r"j\1", text)
    text = re.sub("u([aoəe])", r"w\1", text)
    # erhua coda marker '&' (from zh_frontend._merge_erhua): retroflex the
    # rhyme, deleting a final alveolar nasal (wan + er -> waɻ)
    text = re.sub("n?([→↓↑]*)&", r"ɻ\1", text)
    text = re.sub("([sɹ]`[⁼ʰ]?)([→↓↑ ]+|$)", r"\1ɹ`\2", text).replace("ɻ", "ɹ`")
    text = re.sub("(s[⁼ʰ]?)([→↓↑ ]+|$)", r"\1ɹ\2", text)
    return text


def pinyin_to_ipa(text: str) -> str:
    """Raw tone-numbered pinyin (the [P] tag) -> IPA. Pure python.

    Reference: mandarin.py:126-130 / paddle_zh.py:106-108. Input: pinyin
    syllables separated by spaces, `#` as word separator, e.g. `ni3#hao3`.
    """
    text = bopomofo(text)
    text = text.replace(" ", "").replace("#", " ").replace("%", "% ")
    text = _clean_zh(text)
    return text.replace("%", " %").replace("$", " $")


def chinese_to_ipa(text: str, with_erhua: bool = False) -> str:
    """Full hanzi path (reference mandarin.py:119-123): trad->simp + NSW
    normalization -> punctuation -> segmentation + pinyin + tone sandhi
    (vits_tpu.text.zh_frontend, dependency-free) -> bopomofo -> IPA."""
    from perfbench.reference.text.zh_frontend import hanzi_to_pinyin
    from perfbench.reference.text.zh_normalization import TextNormalizer

    text = text.replace("嗯", "恩")  # reference zh_frontend.py:263
    text = TextNormalizer().normalize(text)
    text = number_to_chinese(text)  # safety net for leftovers
    text = pu_symbol_replace(text)
    pinyin = hanzi_to_pinyin(text, with_erhua=with_erhua)
    text = bopomofo(pinyin)
    text = text.replace(" ", "").replace("#", " ")
    return _clean_zh(text)
