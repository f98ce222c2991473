"""Text frontend: trilingual (ZH/JA/EN) IPA g2p with per-char language ids.

Behavioral reference: reference text/. The 55-symbol IPA vocabulary and
the `[JA]..[JA] [ZH]..[ZH] [EN]..[EN] [P]..[P]` tagged-text contract are the
model's input interface and are preserved exactly.

G2P backends are pluggable: when the reference's external libraries
(pyopenjtalk, pypinyin+jieba, eng_to_ipa, g2p_en, ...) are installed the
full pipelines run; otherwise pure-python fallbacks cover raw-pinyin [P],
kana-only Japanese, and dictionary-free English letter-to-sound.
"""

from perfbench.reference.text.symbols import symbols, SPACE_ID

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}


def cleaned_text_to_sequence(cleaned_text: str) -> list[int]:
    """IPA string -> symbol ids (reference text/__init__.py:6-15)."""
    return [_symbol_to_id[s] for s in cleaned_text]


def sequence_to_text(sequence) -> str:
    return "".join(_id_to_symbol[int(i)] for i in sequence)
