"""Language-tagged text cleaner: `[JA]..[JA] [ZH]..[ZH] [EN]..[EN] [P]..[P]`
blocks -> concatenated IPA + per-character language-id sequence.

Behavioral reference: reference text/cleaners.py. Language-id map:
ZH/P=0, JA=1, EN=3, untagged=5 (dropped by remove_invalid_text).
"""

from __future__ import annotations

import logging
import re

from perfbench.reference.text import cleaned_text_to_sequence
from perfbench.reference.text.symbols import symbols

logger = logging.getLogger(__name__)

lang_map = {"ZH": 0, "JA": 1, "EN": 3, "P": 0, "other": 5}

_BLOCK_RE = re.compile(r"\[(JA|ZH|EN|P)\](.*?)\[\1\]")


def str_replace(data: str) -> str:
    """Punctuation normalization (reference cleaners.py:10-18)."""
    zh_tab = [";", ":", '"', "'"]
    eng_tab = [".", ",", " ", " "]
    for z, e in zip(zh_tab, eng_tab):
        if z in data:
            data = data.replace(z, e)
    return data


def cje_cleaner(text: str):
    """Per-block g2p dispatch (reference cleaners.py:43-92)."""
    from perfbench.reference.text.english import english_to_ipa
    from perfbench.reference.text.japanese import japanese_to_ipa
    from perfbench.reference.text.mandarin import chinese_to_ipa, pinyin_to_ipa

    # NOTE: str_replace maps apostrophes to spaces on the RAW input
    # (reference cleaners.py:44) — aimed at ZH quote marks, but it also
    # splits EN contractions ("can't" -> "kæn t") before g2p. Kept for
    # byte-parity with the reference's input distribution; call
    # english_to_ipa directly for apostrophe-aware transcription.
    text = str_replace(text).replace('"', "")
    original_text = text

    cleaned_text = ""
    lang_seq: list[int] = []
    last_end = 0

    for block in _BLOCK_RE.finditer(text):
        start, end = block.span()
        outside = original_text[last_end:start]
        lang_seq += [lang_map["other"]] * len(outside)
        cleaned_text += outside
        last_end = end

        language = block.group(1)
        inner = block.group(2)
        if language == "P":
            ipa = pinyin_to_ipa(inner)
        elif language == "JA":
            ipa = japanese_to_ipa(inner)
        elif language == "ZH":
            ipa = chinese_to_ipa(inner)
        elif language == "EN":
            ipa = english_to_ipa(inner)
        else:  # pragma: no cover
            ipa = inner
        lang_seq += [lang_map[language]] * len(ipa)
        cleaned_text += ipa

    tail = original_text[last_end:]
    lang_seq += [lang_map["other"]] * len(tail)
    cleaned_text += tail

    assert len(cleaned_text) == len(lang_seq)
    return cleaned_text, lang_seq


def remove_invalid_text(cleaned_text: str, lang_seq: list[int]):
    """Drop symbols outside the vocabulary and untagged text
    (reference cleaners.py:95-113)."""
    out_text = ""
    out_lang = []
    for symbol, la in zip(cleaned_text, lang_seq):
        if symbol not in symbols:
            logger.warning("Invalid symbol %r in %r", symbol, cleaned_text)
            continue
        if la == lang_map["other"]:
            logger.warning("Untagged symbol %r in %r", symbol, cleaned_text)
            continue
        out_text += symbol
        out_lang.append(la)
    return out_text, out_lang


def clean_text(text: str):
    """Main entry: tagged text -> (IPA string, language ids)
    (reference cleaners.py:21-26)."""
    cleaned_text, lang_seq = cje_cleaner(text)
    cleaned_text = str_replace(cleaned_text)
    return remove_invalid_text(cleaned_text, lang_seq)


def text_to_sequence(text: str):
    cleaned_text, lang_seq = clean_text(text)
    return cleaned_text_to_sequence(cleaned_text), lang_seq
