"""Japanese g2p: text -> romaji with pitch-accent arrows -> IPA.

Behavioral reference: reference text/japanese.py. With pyopenjtalk
installed the full-context-label pipeline runs (accent arrows from A-fields,
accent-phrase spaces); without it, a pure-python kana reader covers
hiragana/katakana input WITH Tokyo-accent arrows: an accent lexicon for
common vocabulary plus the heiban default (initial rise, no fall) — the
same ↑/↓ placement rules the full-context A-fields produce
(reference japanese.py:91-103):
  * accent 0 (heiban):    rise after mora 1          ko↑Nnichiwa
  * accent 1 (atamadaka): fall after mora 1          ha↓i
  * accent k>=2:          rise after 1, fall after k a↑riga↓too
  * a fall on the final mora is inaudible phrase-finally (openjtalk only
    emits it before a following mora), so odaka words get no arrow
"""

from __future__ import annotations

import re

_japanese_characters = re.compile(
    r"[A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚ"
    r"ａ-ｚｦ-ﾝ]"
)
_japanese_marks = re.compile(
    r"[^A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚ"
    r"ａ-ｚｦ-ﾝ]"
)

_SYMBOLS_TO_JAPANESE = [
    (re.compile("％"), "パーセント"),  # reference japanese.py:15-17
    # beyond the reference: half-width %, ㌫, and decimal points would
    # otherwise split the sentence at the marks regex and read wrong
    (re.compile("%"), "パーセント"),
    (re.compile("㌫"), "パーセント"),
    (re.compile(r"(\d)\.(?=\d)"), r"\1てん"),
]

_ROMAJI_TO_IPA = [
    (re.compile(p), r)
    for p, r in [
        ("u", "ɯ"), ("ʧ", "tʃ"), ("j", "dʑ"), ("y", "j"),
        ("ni", "n^i"), ("nj", "n^"), ("hi", "çi"), ("hj", "ç"),
        ("f", "ɸ"), ("I", "i*"), ("U", "ɯ*"), ("r", "ɾ"),
    ]
]

_REAL_SOKUON = [
    (re.compile(p), r)
    for p, r in [
        (r"Q([↑↓]*[kg])", r"k#\1"),
        (r"Q([↑↓]*[tdjʧ])", r"t#\1"),
        (r"Q([↑↓]*[sʃ])", r"s\1"),
        (r"Q([↑↓]*[pb])", r"p#\1"),
    ]
]

_REAL_HATSUON = [
    (re.compile(p), r)
    for p, r in [
        (r"N([↑↓]*[pbm])", r"m\1"),
        (r"N([↑↓]*[ʧʥj])", r"n^\1"),
        (r"N([↑↓]*[tdn])", r"n\1"),
        (r"N([↑↓]*[kg])", r"ŋ\1"),
    ]
]

# -- pure-python kana reader (fallback; openjtalk phoneme alphabet) ---------

_KANA_BASE = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "さ": "sa", "し": "ʃi", "す": "su", "せ": "se", "そ": "so",
    "た": "ta", "ち": "ʧi", "つ": "tsu", "て": "te", "と": "to",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "N",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゔ": "vu", "ゕ": "ka", "ゖ": "ka",  # ヴ / counter ヵ・ヶ (一ヶ月)
    "ゃ": "ya", "ゅ": "yu", "ょ": "yo",  # orphan small yoon: never leak raw
    "ー": "",  # long vowel handled below
}
_KANA_YOON = {
    "きゃ": "kya", "きゅ": "kyu", "きょ": "kyo",
    "しゃ": "ʃa", "しゅ": "ʃu", "しょ": "ʃo",
    "ちゃ": "ʧa", "ちゅ": "ʧu", "ちょ": "ʧo",
    "にゃ": "nya", "にゅ": "nyu", "にょ": "nyo",
    "ひゃ": "hya", "ひゅ": "hyu", "ひょ": "hyo",
    "みゃ": "mya", "みゅ": "myu", "みょ": "myo",
    "りゃ": "rya", "りゅ": "ryu", "りょ": "ryo",
    "ぎゃ": "gya", "ぎゅ": "gyu", "ぎょ": "gyo",
    "じゃ": "ja", "じゅ": "ju", "じょ": "jo",
    "びゃ": "bya", "びゅ": "byu", "びょ": "byo",
    "ぴゃ": "pya", "ぴゅ": "pyu", "ぴょ": "pyo",
    # foreign-sound moras (katakana loanwords; openjtalk phoneme alphabet:
    # フォン -> f o N, ティ -> t i, ヴァ -> v a, チェ -> ch e ...)
    "うぃ": "wi", "うぇ": "we", "うぉ": "wo", "いぇ": "ye",
    "ふぁ": "fa", "ふぃ": "fi", "ふぇ": "fe", "ふぉ": "fo", "ふゅ": "fyu",
    "てぃ": "ti", "てゅ": "tyu", "でぃ": "di", "でゅ": "dyu",
    "とぅ": "tu", "どぅ": "du", "すぃ": "si", "ずぃ": "zi",
    "ちぇ": "ʧe", "しぇ": "ʃe", "じぇ": "je",
    "つぁ": "tsa", "つぃ": "tsi", "つぇ": "tse", "つぉ": "tso",
    "ゔぁ": "va", "ゔぃ": "vi", "ゔぇ": "ve", "ゔぉ": "vo", "ゔゅ": "vyu",
}


def _katakana_to_hiragana(text: str) -> str:
    out = []
    for ch in text:
        code = ord(ch)
        if 0x30A1 <= code <= 0x30F6:
            out.append(chr(code - 0x60))
        else:
            out.append(ch)
    return "".join(out)


# lexicalized readings the kana-literal fallback would get wrong
_KANA_EXCEPTIONS = {
    "こんにちは": "こんにちわ",
    "こんばんは": "こんばんわ",
}

# reading -> Tokyo accent nucleus, derived from the word lexicon; used for
# kana-only input that matches no surface entry (e.g. せんせい typed in kana)
from perfbench.reference.text.kanji_dict import WORDS as _BASE_WORDS, CHARS as _CHAR_READINGS

# derive i-adjective inflections from base entries (高い -> 高かった,
# 高くない, 高くて, 高く, 高ければ): surface and reading both end in い and
# the stem stays put, so the paradigm is purely suffixal. The nucleus for
# inflected forms falls on the mora before the suffix for accented
# adjectives (高い[2] -> 高かった たか↓かった) and stays heiban for [0].
_I_ADJ_SUFFIXES = ("かった", "くない", "くなかった", "くなければ", "くて",
                   "く", "ければ", "さ", "そう")
# い-final entries that are NOT i-adjectives (na-adjectives, nouns,
# auxiliaries): the paradigm would manufacture junk that can corrupt real
# text — 嫌い generated 嫌そう(きらそう), which then beat 嫌(いや)+そう
_NOT_I_ADJ = {
    "嫌い", "大嫌い", "きらい", "きれい", "綺麗", "みたい", "ちょうだい",
    "くらい", "ぐらい", "いっぱい", "間違い", "勘違い", "気遣い", "出会い",
    "戦い", "願い", "お願い", "匂い", "想い", "思い", "扱い", "笑い",
    "迷い", "酔い", "悔い", "報い", "違い", "呪い", "誓い", "狙い",
    "救い", "問い", "行い", "祝い", "お祝い", "付き合い", "話し合い",
    "人見知り", "お互い", "互い", "知り合い", "頃合い", "場合い",
}
_WORDS: dict[str, tuple[str, int | None]] = dict(_BASE_WORDS)
for _surf, (_read, _acc) in _BASE_WORDS.items():
    if _surf in _NOT_I_ADJ:
        continue
    if (len(_surf) >= 2 and _surf.endswith("い") and _read.endswith("い")
            and len(_read) >= 2):
        for _sfx in _I_ADJ_SUFFIXES:
            _key = _surf[:-1] + _sfx
            if _key in _BASE_WORDS:
                continue  # hand-written entry wins
            _a = None if _acc is None else (
                0 if _acc == 0 else len(_read) - 1
            )
            _WORDS[_key] = (_read[:-1] + _sfx, _a)
        # excessive 〜すぎる (高い -> 高すぎる, nucleus on ぎ: たかすぎ↓る);
        # an ichidan verb, so the polite pass below derives 〜すぎます etc.
        _key = _surf[:-1] + "すぎる"
        if _key not in _BASE_WORDS:
            _r = _read[:-1] + "すぎる"
            _WORDS[_key] = (_r, len(_r) - 1)

# derive the polite-verb paradigm. Two sources:
#   * existing ます entries (会います -> 会いません/会いました/会いましょう)
#   * dictionary-form verbs (歌う -> 歌います...): godan final u-row kana
#     maps to the i-row stem (う->い, く->き, ...); ichidan (reading ends
#     in i/e-row + る) drops る. Irregular verbs (帰る etc.) have
#     hand-written entries, which always win.
# Accent (Tokyo): ます on ま, ません on せ, ました on ま, ましょう on しょ —
# moras-2 / moras-1 / moras-2 / moras-1 counted on the derived reading.
_GODAN_STEM = {"う": "い", "く": "き", "ぐ": "ぎ", "す": "し", "つ": "ち",
               "ぬ": "に", "ぶ": "び", "む": "み", "る": "り"}
_IE_ROW = set("いきしちにひみりぎじびぴえけせてねへめれげぜべぺで")
_POLITE = (("ます", 2), ("ません", 1), ("ました", 2), ("ましょう", 1),
           ("まして", 2))


def _polite_add(surf_stem: str, read_stem: str) -> None:
    for _sfx, _back in _POLITE:
        _key = surf_stem + _sfx
        if _key in _WORDS:
            continue  # hand-written entry wins
        _r = read_stem + _sfx
        _moras = len(_r) - _r.count("ょ")  # ょ merges with preceding kana
        _WORDS[_key] = (_r, _moras - _back)


def _is_polite_masu(surf: str, read: str) -> bool:
    """~ます is the polite auxiliary (follows an i-row connective stem:
    あいます, ございます) — not a dictionary す-verb (励ます, 冷ます, whose
    reading has a non-i-row kana before ます). Only the former may feed
    the polite paradigm; the latter inflects as a regular godan verb."""
    return (surf.endswith("ます") and read.endswith("ます")
            and len(read) >= 3 and read[-3] in _IE_ROW)


# compound-verb base readings with an internal え-row + い morpheme
# boundary: mark it BEFORE derivation so every derived form (恐れ入ります)
# carries the sentinel and the ei->ee merge cannot fire (おそれ|いります)
for _surf, _marked in (("恐れ入る", "おそれ|いる"), ("おうち", "お|うち"),
                       ("聖遺物", "せい|いぶつ"),
                       ("受け入れる", "うけ|いれる")):
    if _surf in _WORDS:
        _WORDS[_surf] = (_marked, _WORDS[_surf][1])

# Derivation passes run over ONE snapshot (base + i-adjective paradigm):
# deriving from already-derived forms manufactures junk (していましょう is
# not a godan う-verb; おはようございます is not a す-verb to conjugate).
_DERIVE_BASE = list(_WORDS.items())

for _surf, (_read, _acc) in _DERIVE_BASE:
    if _is_polite_masu(_surf, _read):
        _polite_add(_surf[:-2], _read[:-2])
    elif (len(_surf) >= 2 and len(_read) >= 2
          and _surf[-1] in _GODAN_STEM and _read[-1] == _surf[-1]
          and not _surf.endswith("ない")
          and not _surf.endswith("ょう")):  # ~ましょう/~でしょう volitional
        if _surf[-1] == "る" and _read[-2] in _IE_ROW:
            _polite_add(_surf[:-1], _read[:-1])  # ichidan: drop る
        else:
            _polite_add(
                _surf[:-1] + _GODAN_STEM[_surf[-1]],
                _read[:-1] + _GODAN_STEM[_read[-1]],
            )

# derive plain-form inflections from dictionary-form verbs: te-form
# (願う -> 願って), plain past (願った), negative (願わない), desiderative
# (願いたい + its adjective paradigm) and the bare masu-stem (願い) so that
# segmentation reads inflected verbs instead of falling back to per-kanji
# on'yomi. Gemination/sound-change follows the standard godan table
# (う/つ/る -> って, む/ぶ/ぬ -> んで, く -> いて, ぐ -> いで, す -> して);
# ichidan drops る. Irregulars (行って, 来て, して...) are hand-written in
# kanji_dict and always win. Accent: heiban verbs stay heiban; accented
# verbs keep their nucleus for て/た (待つ[1] -> 待って[1]), move to the
# mora before ない (書く[1] -> 書かな↓い is かか↓ない), and to た for たい.
_GODAN_TE = {"う": "って", "つ": "って", "る": "って", "む": "んで",
             "ぶ": "んで", "ぬ": "んで", "く": "いて", "ぐ": "いで",
             "す": "して"}
_GODAN_NAI = {"う": "わ", "く": "か", "ぐ": "が", "す": "さ", "つ": "た",
              "ぬ": "な", "ぶ": "ば", "む": "ま", "る": "ら"}
_GODAN_POT = {"う": "え", "く": "け", "ぐ": "げ", "す": "せ", "つ": "て",
              "ぬ": "ね", "ぶ": "べ", "む": "め", "る": "れ"}


def _moras_len(read: str) -> int:
    read = read.replace("|", "")
    return len(read) - sum(read.count(c) for c in "ゃゅょ")


def _plain_add(key: str, read: str, acc: int | None) -> None:
    if key not in _WORDS:
        _WORDS[key] = (read, acc)


_E_ROW = set("えけせてねへめれげぜでべぺ")


def _verb_forms_add(surf_stem, read_stem, te, nai_row, acc):
    # te / ta. い-onbin forms after an え-row stem mora carry a morpheme
    # boundary so the ei->ee long-vowel merge cannot fire (嘆いて must stay
    # nageite, 稼いで kaseide — not nageete/kaseede)
    # てしまう contractions ride the te-stem: 待っ+ちゃう, 飲ん+じゃう,
    # 書い+ちゃう, 食べ+ちゃう (で-te verbs voice to じゃう)
    _contr = "じゃ" if te[-1] == "で" else "ちゃ"
    _sfxes = [te, te[:-1] + ("だ" if te[-1] == "で" else "た")]
    _sfxes += [te[:-1] + _contr + _end
               for _end in ("う", "った", "って", "おう", "えば")]
    # the bare ては-contraction (動いちゃ駄目) is derived with accent None
    # so its KANA reading never enters _READING_ACCENT — a particle-like
    # 2-mora tail there steals across word boundaries (乱す+ん+じゃない
    # must not become 乱+すんじゃ+ない via 済んじゃ's kana reading); the
    # kanji surface itself still matches as a word
    _bare = te[:-1] + _contr
    _rb = read_stem + _bare
    if _bare[0] == "い" and read_stem and read_stem[-1] in _E_ROW:
        _rb = read_stem + "|" + _bare
    _plain_add(surf_stem + _bare, _rb, None)
    for _sfx in _sfxes:
        _r = read_stem + _sfx
        if _sfx[0] == "い" and read_stem and read_stem[-1] in _E_ROW:
            _r = read_stem + "|" + _sfx
        _a = acc if acc in (None, 0) else min(acc, _moras_len(_r.replace("|", "")) - 1)
        _plain_add(surf_stem + _sfx, _r, _a)
    # negative 〜ない (+ past/conditional/conjunctive negatives; なきゃ/
    # なくちゃ contractions and the rough ん-negative for VN dialogue)
    if nai_row is not None:
        for _sfx, _back in (("ない", 2), ("なかった", 4), ("なければ", 4),
                            ("ないで", 3), ("ず", 1), ("ずに", 2),
                            ("なきゃ", 2), ("なくちゃ", 3), ("ん", 1),
                            ("なくて", 3), ("ねぇ", 2), ("ねえ", 2)):
            _r = read_stem + nai_row + _sfx
            _a = acc if acc in (None, 0) else _moras_len(_r) - _back
            _plain_add(surf_stem + nai_row + _sfx, _r, _a)


def _tai_forms_add(surf_istem, read_istem, acc):
    # accented verbs put the たい-form nucleus on た (のみた↓い, OJAD),
    # i.e. one mora later than the stem-final placement this used to emit
    for _sfx, _back in (("たい", 1), ("たくない", 2), ("たかった", 4),
                        ("たくて", 3)):
        _r = read_istem + _sfx
        _a = acc if acc in (None, 0) else _moras_len(_r) - _back
        _plain_add(surf_istem + _sfx, _r, _a)


# kana entries that END in a u-row kana but are NOT dictionary-form verbs:
# interjections, pronouns, adverbs and lexicalized forms. Without this the
# verb paradigm manufactures ありがとう -> ありがとって, あいつ -> あいって
_NOT_VERB = {
    "おはよう", "ありがとう", "おめでとう", "そうです", "だいじょうぶ",
    "あいつ", "こいつ", "そいつ", "どいつ", "どういう", "そういう",
    "こういう", "ああいう", "している", "もう", "すぐ", "こう", "そう",
    "どう", "いつ", "いくつ", "ふつう", "べつ", "やつ", "こいつら",
    "あいつら", "ずつ", "かつ",
}

# godan verbs ending る whose reading penult is i/e-row (the ichidan
# heuristic misfires): surface suffixes disambiguate — 切る(きる) is godan
# while 着る(きる) is ichidan. Compounds (思い切る) match by endswith.
_GODAN_RU = (
    "帰る", "返る", "入る", "切る", "知る", "走る", "要る", "喋る",
    "焦る", "限る", "握る", "参る", "滑る", "蹴る", "減る", "照る",
    "散る", "罵る", "遮る", "陥る", "蘇る", "嘲る", "弄る", "捻る",
    "湿る", "茂る", "過る", "齧る", "はしる", "しゃべる", "びびる",
    "さぼる", "いじる", "かじる", "しくじる", "むしる", "ビビる",
    "サボる",
)

for _surf, (_read, _acc) in _DERIVE_BASE:
    if _surf in _NOT_VERB:
        continue
    if (len(_surf) >= 2 and len(_read) >= 2
            and _surf[-1] in _GODAN_STEM and _read[-1] == _surf[-1]
            and not _surf.endswith("ない") and not _surf.endswith("たい")
            and not _surf.endswith("ょう")
            and not _is_polite_masu(_surf, _read)):
        if (_surf[-1] == "る" and _read[-2] in _IE_ROW
                and not _surf.endswith(_GODAN_RU)):
            # ichidan: 食べる -> 食べて/食べた/食べない/食べたい; stem 食べ;
            # potential/passive 食べられる (+ its own て/polite forms)
            _verb_forms_add(_surf[:-1], _read[:-1], "て", "", _acc)
            _tai_forms_add(_surf[:-1], _read[:-1], _acc)
            # bare ichidan stem as a word — but never a SINGLE kana: 居る's
            # stem い dismembered every ない into な+い with a phrase break
            if len(_surf) >= 3:
                _plain_add(_surf[:-1], _read[:-1], None)
            _pot_s, _pot_r = _surf[:-1] + "られ", _read[:-1] + "られ"
            _pa = _acc if _acc in (None, 0) else _moras_len(_pot_r + "る") - 1
            _plain_add(_pot_s + "る", _pot_r + "る", _pa)
            _polite_add(_pot_s, _pot_r)
            _verb_forms_add(_pot_s, _pot_r, "て", "", _pa)
            # causative 食べさせる, an ichidan verb of its own
            _cau_s, _cau_r = _surf[:-1] + "させ", _read[:-1] + "させ"
            _ca = _acc if _acc in (None, 0) else _moras_len(_cau_r + "る") - 1
            _plain_add(_cau_s + "る", _cau_r + "る", _ca)
            _polite_add(_cau_s, _cau_r)
            _verb_forms_add(_cau_s, _cau_r, "て", "", _ca)
            # volitional 食べよう / conditional 食べれば
            _vr = _read[:-1] + "よう"
            _plain_add(_surf[:-1] + "よう", _vr, _moras_len(_vr) - 1)
            _br = _read[:-1] + "れば"
            _ba = _acc if _acc in (None, 0) else min(_acc, _moras_len(_br) - 1)
            _plain_add(_surf[:-1] + "れば", _br, _ba)
            # imperative 食べろ (VN dialogue is full of imperatives)
            _plain_add(_surf[:-1] + "ろ", _read[:-1] + "ろ",
                       _moras_len(_read[:-1] + "ろ") - 1)
        else:
            _fin = _surf[-1]
            _verb_forms_add(_surf[:-1], _read[:-1], _GODAN_TE[_fin],
                            _GODAN_NAI[_fin], _acc)
            _istem_s = _surf[:-1] + _GODAN_STEM[_fin]
            _istem_r = _read[:-1] + _GODAN_STEM[_fin]
            _tai_forms_add(_istem_s, _istem_r, _acc)
            if len(_istem_s) >= 2:
                _plain_add(_istem_s, _istem_r, None)
            # potential (読む -> 読める), an ichidan verb of its own
            _pot_s = _surf[:-1] + _GODAN_POT[_fin]
            _pot_r = _read[:-1] + _GODAN_POT[_fin]
            _pa = _acc if _acc in (None, 0) else _moras_len(_pot_r + "る") - 1
            _plain_add(_pot_s + "る", _pot_r + "る", _pa)
            _polite_add(_pot_s, _pot_r)
            _verb_forms_add(_pot_s, _pot_r, "て", "", _pa)
            # volitional 行こう (o-row + う) / conditional 行けば (e-row + ば)
            _GODAN_O = {"う": "お", "く": "こ", "ぐ": "ご", "す": "そ",
                        "つ": "と", "ぬ": "の", "ぶ": "ぼ", "む": "も",
                        "る": "ろ"}
            _vr = _read[:-1] + _GODAN_O[_fin] + "う"
            _plain_add(_surf[:-1] + _GODAN_O[_fin] + "う", _vr,
                       _moras_len(_vr) - 1)
            _br = _pot_r + "ば"
            _ba = _acc if _acc in (None, 0) else min(_acc, _moras_len(_br) - 1)
            _plain_add(_pot_s + "ば", _br, _ba)
            # imperative 読め / 動け — the bare e-row stem (also the stem of
            # slang negatives 動けねぇ, which attach ねぇ separately)
            _ia = _acc if _acc in (None, 0) else min(_acc, _moras_len(_pot_r) - 1)
            _plain_add(_pot_s, _pot_r, _ia)
            # passive 読まれる (a-row + れる), an ichidan verb of its own
            _pas_s = _surf[:-1] + _GODAN_NAI[_fin] + "れ"
            _pas_r = _read[:-1] + _GODAN_NAI[_fin] + "れ"
            _psa = _acc if _acc in (None, 0) else _moras_len(_pas_r + "る") - 1
            _plain_add(_pas_s + "る", _pas_r + "る", _psa)
            _polite_add(_pas_s, _pas_r)
            _verb_forms_add(_pas_s, _pas_r, "て", "", _psa)
            # causative 読ませる / 作らせる (a-row + せる), ichidan likewise
            _cau_s = _surf[:-1] + _GODAN_NAI[_fin] + "せ"
            _cau_r = _read[:-1] + _GODAN_NAI[_fin] + "せ"
            _ca = _acc if _acc in (None, 0) else _moras_len(_cau_r + "る") - 1
            _plain_add(_cau_s + "る", _cau_r + "る", _ca)
            _polite_add(_cau_s, _cau_r)
            _verb_forms_add(_cau_s, _cau_r, "て", "", _ca)
            # contracted causative-passive 書かされる (a-row + され)
            _cp_s = _surf[:-1] + _GODAN_NAI[_fin] + "され"
            _cp_r = _read[:-1] + _GODAN_NAI[_fin] + "され"
            _cpa = _acc if _acc in (None, 0) else _moras_len(_cp_r + "る") - 1
            _plain_add(_cp_s + "る", _cp_r + "る", _cpa)
            _verb_forms_add(_cp_s, _cp_r, "て", "", _cpa)

# て/で + い-initial subsidiary verb inside a lexicon reading (している,
# 知っている, 住んでいる and their derived forms): mark the morpheme
# boundary so the ei->ee long-vowel merge cannot fire across it. The
# [っんし] guard restricts the rewrite to te-form composites — a
# Sino-Japanese てい sequence (提供 ていきょう, 定期 ていき) never follows
# っ/ん/し-て and keeps its merge. "|" is stripped from the romaji output.
_TE_I_COMPOSITE = re.compile(
    r"([っんし][てで])(い(?:る|れば|ます|まし|ませ|た|て|な|き|く|ただ|らっしゃ))"
)
for _surf in list(_WORDS):
    _read, _acc = _WORDS[_surf]
    _new = _TE_I_COMPOSITE.sub(r"\1|\2", _read)
    if _new != _read:
        _WORDS[_surf] = (_new, _acc)

# hand-marked morpheme boundaries the composite regex cannot infer
# (そのうち must read sono-uchi, not merge のう -> noo)
for _surf, _marked in (("そのうち", "その|うち"),):
    if _surf in _WORDS:
        _WORDS[_surf] = (_marked, _WORDS[_surf][1])

_READING_ACCENT: dict[str, int] = {}
for _surf, (_read, _acc) in _WORDS.items():
    if _acc is not None:
        _READING_ACCENT.setdefault(_read.replace("|", ""), _acc)

# particles / auxiliaries that attach to the preceding accent phrase.
# Topic は reads わ, direction へ reads え, object を reads お — the openjtalk
# pronunciations the plain kana table cannot produce
# (reference japanese.py:58-73 gets these from the full-context labels).
_ATTACH = {
    "は": "わ", "へ": "え", "を": "お",
    "が": "が", "に": "に", "で": "で", "と": "と", "も": "も", "の": "の",
    "や": "や", "か": "か", "ね": "ね", "よ": "よ", "な": "な", "ぞ": "ぞ",
    "さ": "さ", "わ": "わ",
    "から": "から", "まで": "まで", "より": "より", "ほど": "ほど",
    "など": "など", "だけ": "だけ", "しか": "しか", "ばかり": "ばかり",
    "くらい": "くらい", "ぐらい": "ぐらい", "ながら": "ながら",
    "のに": "のに", "ので": "ので", "けど": "けど", "けれど": "けれど",
    "でも": "でも", "では": "でわ", "には": "にわ", "とは": "とわ",
    "です": "です", "でした": "でした", "でしょう": "でしょう",
    "でしょ": "でしょ",
    "ます": "ます", "ました": "ました", "ません": "ません",
    "ましょう": "ましょう", "ください": "ください",
    "だ": "だ", "だった": "だった", "じゃない": "じゃない",
    "ですね": "ですね", "ですよ": "ですよ", "ですか": "ですか",
    "なさい": "なさい",
    # する-passive auxiliaries (審議される etc. — される must not split
    # into さ+れる across an accent-phrase boundary). されて+い carries the
    # morpheme-boundary sentinel so the ei->ee merge cannot fire across it
    # (されています must read sareteimasu, not sareteemasu).
    "される": "される", "されます": "されます",
    "されました": "されました", "された": "された", "されて": "されて",
    "されている": "されて|いる", "されています": "されて|います",
    "されない": "されない", "されません": "されません",
    # よう-auxiliaries (V-るように, N-のようです): without these the DP
    # splits よ|うに because bare よ is a particle, reading "yo u ni"
    "ように": "ように", "ような": "ような", "ようで": "ようで",
    "ようです": "ようです", "ようだ": "ようだ", "ようだった": "ようだった",
    "よう": "よう",
    # explanatory んだ/んです family (思うんだけど was losing 思う to the
    # derived kana reading うんだ of 産んだ)
    "んだ": "んだ", "んだけど": "んだけど", "んだよ": "んだよ",
    "んだね": "んだね", "んだって": "んだって", "んだろう": "んだろう",
    "んです": "んです", "んですか": "んですか", "んですけど": "んですけど",
    "んですが": "んですが", "んじゃない": "んじゃない",
    "んじゃないか": "んじゃないか", "んじゃ": "んじゃ",
    "んでしょ": "んでしょ", "んでしょう": "んでしょう",
    # conjunctive/suru-stem し (あるし / 破壊し終わる — both read し)
    "し": "し",
    # conditional copula なら (私なら was splitting な+ら, 259 corpus hits)
    "なら": "なら", "ならば": "ならば",
    # suru-te forms after nouns (通報して was severing at し)
    "して": "して", "しても": "しても", "したら": "したら",
    "しては": "しては", "してる": "してる", "してた": "してた",
    # negative auxiliary after words (なんでもない, 黙ってない)
    "ない": "ない", "なかった": "なかった",
    # hearsay/appearance auxiliaries (できたらしい must not shed its らしい)
    "らしい": "らしい", "らしいです": "らしいです",
    "らしかった": "らしかった", "みたい": "みたい",
    # keigo auxiliaries: いただく receiving family (教えていただけますか —
    # without these, 抱ける's kana reading だけます can steal いた|だけます)
    "いただく": "いただく", "いただきます": "いただきます",
    "いただきました": "いただきました", "いただいて": "いただいて",
    "いただける": "いただける", "いただけます": "いただけます",
    "いただけますか": "いただけますか",
    "いただけますでしょうか": "いただけますでしょうか",
    "いただけると": "いただけると", "いただけたら": "いただけたら",
    # keigo auxiliaries: ござる politeness and させる causative families
    # (ご質問がございましたら / 変更させていただきます)
    "ございます": "ございます", "ございません": "ございません",
    "ございました": "ございました", "ございましたら": "ございましたら",
    # conjecture/emphasis tails and slang negative
    "なんて": "なんて", "なんか": "なんか",
    "ねぇ": "ねえ", "ねえ": "ねえ", "かつ": "かつ",
    "かしら": "かしら", "なく": "なく",
    "だろ": "だろ", "だろう": "だろう", "だったら": "だったら",
    "でしたら": "でしたら", "ちょうだい": "ちょうだい",
    # volume auxiliary まくる (撮りまくって attaches to the masu-stem)
    "まくる": "まくる", "まくって": "まくって", "まくり": "まくり",
    # quotative/topic って (可愛いって言って was falling apart into
    # 可+愛+いって because って could not attach)
    "って": "って", "ってば": "ってば",
    # comparative 方が reads ほう (送った方がいい, 病院の方が安心);
    # the polite-person reading keeps 方は/方も (男の方はタカミネ)
    "方が": "ほうが", "方がいい": "ほうがいい",
    # name suffixes (新海くんは: without these くんは merges into one raw
    # kana token and the topic は cannot read わ)
    "くん": "くん", "さん": "さん", "ちゃん": "ちゃん", "さま": "さま",
    "たち": "たち",
    "させる": "させる", "させて": "させて", "させます": "させます",
    "させました": "させました", "させてください": "させてください",
}

_MAX_SURFACE = max(
    max(len(k) for k in _WORDS), max(len(k) for k in _ATTACH)
)

# --- digit runs -> kana (openjtalk reads numbers; the fallback must too) ---

_NUM_KANA = ["ぜろ", "いち", "に", "さん", "よん", "ご", "ろく", "なな",
             "はち", "きゅう"]
_NUM_HYAKU = {3: "さんびゃく", 6: "ろっぴゃく", 8: "はっぴゃく"}
_NUM_SEN = {3: "さんぜん", 8: "はっせん"}


def _number_to_kana(digits: str) -> str:
    if len(digits) > 1 and digits[0] == "0":
        # leading zero marks a code-like number (03 area code, 007):
        # read digit-by-digit, as openjtalk does
        return "".join(_NUM_KANA[int(d)] for d in digits)
    n = int(digits)
    if n == 0:
        return "ぜろ"
    if n >= 10**12:  # read digit-by-digit beyond 億 range
        return "".join(_NUM_KANA[int(d)] for d in digits)
    out = ""
    oku, n = divmod(n, 10**8)
    if oku:
        out += (_number_to_kana(str(oku)) if oku > 1 else "いち") + "おく"
        if n == 0:
            return out
    man, rest = divmod(n, 10000)
    if man:
        out += (_number_to_kana(str(man)) if man > 1 else "いち") + "まん"
    sen, rest = divmod(rest, 1000)
    if sen:
        out += _NUM_SEN.get(sen, ("" if sen == 1 else _NUM_KANA[sen]) + "せん")
    hyaku, rest = divmod(rest, 100)
    if hyaku:
        out += _NUM_HYAKU.get(
            hyaku, ("" if hyaku == 1 else _NUM_KANA[hyaku]) + "ひゃく"
        )
    juu, one = divmod(rest, 10)
    if juu:
        out += ("" if juu == 1 else _NUM_KANA[juu]) + "じゅう"
    if one:
        out += _NUM_KANA[one]
    return out


_KANJI_DIGITS = {"〇": 0, "零": 0, "一": 1, "二": 2, "三": 3, "四": 4,
                 "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
_KANJI_MULT = {"十": 10, "百": 100, "千": 1000}
_KANJI_GROUP = {"万": 10**4, "億": 10**8}


def _parse_kanji_number(s: str, i: int) -> tuple[int | None, int]:
    """Parse a kanji numeral starting at s[i] (二千二十四, 三百, 一九八四).

    Returns (value, end_index) or (None, i). Bare multipliers (十, 百, 千)
    count with an implicit 1; a group char (万/億) needs preceding digits.
    """
    total = 0
    section = 0
    num = 0
    j = i
    seen = False
    while j < len(s):
        ch = s[j]
        if ch in _KANJI_DIGITS:
            num = num * 10 + _KANJI_DIGITS[ch]
            seen = True
        elif ch in _KANJI_MULT:
            section += (num if num else 1) * _KANJI_MULT[ch]
            num = 0
            seen = True
        elif ch in _KANJI_GROUP:
            if not seen:
                break
            total += (section + num if (section + num) else 1) * _KANJI_GROUP[ch]
            section = num = 0
        else:
            break
        j += 1
    if not seen:
        return None, i
    return total + section + num, j


# counters after an ASCII-digit run: base readings + the common euphonic
# changes (いち+ほん -> いっぽん etc.) and irregulars (4人 よにん, 1人 ひとり)
_COUNTERS = {
    "人": "にん", "個": "こ", "本": "ほん", "分": "ふん", "時": "じ",
    "日": "にち", "月": "がつ", "年": "ねん", "円": "えん", "回": "かい",
    "歳": "さい", "才": "さい", "冊": "さつ", "枚": "まい", "台": "だい",
    "匹": "ひき", "度": "ど", "番": "ばん", "階": "かい", "秒": "びょう",
    "週": "しゅう", "点": "てん", "頭": "とう", "杯": "はい", "軒": "けん",
    "号": "ごう", "名": "めい", "件": "けん", "巻": "かん",
    "章": "しょう", "課": "か", "泊": "はく", "曲": "きょく",
    "席": "せき", "位": "い", "勝": "しょう", "敗": "はい",
    "倍": "ばい", "割": "わり", "票": "ひょう", "歩": "ほ",
}
# multi-char counters (longest match wins over the single-char table:
# 2時間 is に+じかん, not [2時][間あいだ])
_COUNTERS2 = {
    "時間": "じかん", "年間": "ねんかん", "週間": "しゅうかん",
    "日間": "にちかん", "分間": "ふんかん", "か月": "かげつ",
    "ヶ月": "かげつ", "カ月": "かげつ", "年生": "ねんせい",
    "人前": "にんまえ", "時半": "じはん",
}
_COUNTER_IRREGULAR = {
    ("1", "人"): "ひとり", ("2", "人"): "ふたり", ("4", "人"): "よにん",
    ("4", "時"): "よじ", ("9", "時"): "くじ", ("4", "年"): "よねん",
    ("7", "時"): "しちじ", ("1", "日"): "ついたち", ("2", "日"): "ふつか",
    ("4", "時間"): "よじかん", ("9", "時間"): "くじかん",
    ("7", "時間"): "しちじかん", ("4", "時半"): "よじはん",
    ("9", "時半"): "くじはん", ("7", "時半"): "しちじはん",
    ("3", "日"): "みっか", ("4", "日"): "よっか", ("5", "日"): "いつか",
    ("6", "日"): "むいか", ("7", "日"): "なのか", ("8", "日"): "ようか",
    ("9", "日"): "ここのか", ("10", "日"): "とおか", ("20", "日"): "はつか",
    ("4", "月"): "しがつ", ("7", "月"): "しちがつ", ("9", "月"): "くがつ",
}
_GEMINATING = set("かきくけこさしすせそたちつてとぱぴぷぺぽ")
_H_TO_P = {"は": "ぱ", "ひ": "ぴ", "ふ": "ぷ", "へ": "ぺ", "ほ": "ぽ"}
_H_TO_B = {"は": "ば", "ひ": "び", "ふ": "ぶ", "へ": "べ", "ほ": "ぼ"}


# counters whose numeral compounds take the accent nucleus on the
# numeral's last accentable mora (い↓っぽん, に↓はい, じゅ↓っさい, ろ↓っこ,
# じゅうご↓ふん, さ↓んじ). 人 is special (accent on the counter's first
# mora: さんに↓ん, ひと↓り); everything else (円, 年, 日, 時間...) keeps
# the existing heiban default, which matches ごひゃくえん / にせんねん.
_ACCENTED_COUNTERS = set("本杯歳才個分匹時")


def _counter_accent(counter: str, read: str) -> int | None:
    """Tokyo accent nucleus for a numeral+counter reading, or None for
    heiban (round-5 fixture systematics: 二杯/十歳/六個/十五分 read flat)."""
    base = _COUNTERS.get(counter) or _COUNTERS2.get(counter)
    if base is None:
        return None
    moras = _kana_moras(read)
    n_num = len(moras) - len(_kana_moras(base))
    if n_num <= 0:
        return None
    if counter == "人":
        return n_num + 1
    if counter not in _ACCENTED_COUNTERS:
        return None
    k = n_num
    while k > 0 and moras[k - 1] in ("っ", "ん", "ー"):
        k -= 1
    return k or None


def _counter_token(digits: str, counter: str, suffix: str = ""):
    """("num", reading, accent) token for a numeral+counter (+はん)."""
    read = _counter_reading(digits, counter)
    acc = None if suffix else _counter_accent(counter, read)
    return ("num", read + suffix, acc)


def _counter_reading(digits: str, counter: str) -> str:
    if (digits, counter) in _COUNTER_IRREGULAR:
        return _COUNTER_IRREGULAR[(digits, counter)]
    if counter == "日" and len(digits) > 1 and digits[-1] == "4":
        # X4日 keeps the よっか irregular (14日 じゅうよっか, 24日 にじゅうよっか)
        return _number_to_kana(digits[:-1] + "0") + "よっか"
    base = _COUNTERS.get(counter) or _COUNTERS2[counter]
    num = _number_to_kana(digits)
    head = base[0]
    if head in _H_TO_P:  # h-row counters: 1/6/8/10 geminate+p, 3/ん voice
        if num.endswith("いち"):
            return num[:-2] + "いっ" + _H_TO_P[head] + base[1:]
        if num.endswith("ろく"):
            return num[:-2] + "ろっ" + _H_TO_P[head] + base[1:]
        if num.endswith("はち"):
            return num[:-2] + "はっ" + _H_TO_P[head] + base[1:]
        if num.endswith("じゅう"):
            return num[:-3] + "じゅっ" + _H_TO_P[head] + base[1:]
        if num.endswith("ん"):
            return num + _H_TO_B[head] + base[1:]
        return num + base
    if head in _GEMINATING:
        if num.endswith("いち"):
            return num[:-2] + "いっ" + base
        # はち/じゅう assimilate before k/s/t rows (八歳 hassai, 十冊
        # jussatsu, 十個 jukko); ろく before the k-row only (六個 rokko)
        if num.endswith("はち") and head in "かきくけこさしすせそたちつてと":
            return num[:-2] + "はっ" + base
        if num.endswith("じゅう") and head in "かきくけこさしすせそたちつてと":
            return num[:-3] + "じゅっ" + base
        if num.endswith("ろく") and head in "かきくけこ":
            return num[:-2] + "ろっ" + base
    return num + base


def _parse_arabic_grouped(s: str, i: int) -> tuple[int | None, int]:
    """Parse an arabic-digit numeral with 万/億 group kanji (1万, 2600万,
    1億2600万, 1万5000). Returns (value, end) or (None, i) when no group
    kanji participates (plain digit runs stay on the fast path)."""
    j = i
    total = 0
    seen_group = False
    while j < len(s) and s[j].isdigit():
        k = j
        while k < len(s) and s[k].isdigit():
            k += 1
        num = int(s[j:k])
        if k < len(s) and s[k] in _KANJI_GROUP:
            total += num * _KANJI_GROUP[s[k]]
            j = k + 1
            seen_group = True
        else:
            total += num
            j = k
            break
    if not seen_group:
        return None, i
    return total, j


def _is_kana(ch: str) -> bool:
    code = ord(ch)
    return 0x3041 <= code <= 0x30FF or ch == "ー"


def _is_kanji(ch: str) -> bool:
    return 0x4E00 <= ord(ch) <= 0x9FFF or ch == "々"


def _segment(chunk: str) -> list[tuple[str, str, int | None]]:
    """Min-cost segmentation of a mixed kanji/kana/digit chunk.

    Returns tokens (kind, reading, accent) where kind is one of
    'word' | 'attach' | 'num' | 'kanji' | 'kana' | 'other'. The cost model
    prefers lexicon words, then particles (so 今日はいい splits 今日/は/いい
    rather than stealing はい), then per-character fallbacks.
    """
    n = len(chunk)
    INF = float("inf")
    best = [INF] * (n + 1)
    best[0] = 0.0
    back: list[tuple[int, tuple[str, str, int | None]] | None] = [None] * (n + 1)

    for i in range(n):
        if best[i] == INF:
            continue

        def relax(j: int, cost: float, tok: tuple[str, str, int | None]):
            if best[i] + cost < best[j]:
                best[j] = best[i] + cost
                back[j] = (i, tok)

        for ln in range(min(_MAX_SURFACE, n - i), 0, -1):
            s = chunk[i : i + ln]
            if s in _WORDS:
                # a pure-kana word may not start right after a bare
                # unknown-kanji token: that kana is the kanji's okurigana
                # (歌いましょう must parse 歌+い+ましょう, not 歌|いましょう)
                prev = back[i]
                kana_after_kanji = (
                    all(_is_kana(c) for c in s)
                    and prev is not None and prev[1][0] == "kanji"
                )
                if not kana_after_kanji:
                    read, acc = _WORDS[s]
                    relax(i + ln, 1.0 - 0.01 * ln, ("word", read, acc))
                elif ln >= 3:
                    # pure-kana word right after a bare kanji: usually the
                    # kanji's okurigana, but a long match (旅したい ->
                    # したい) is likelier a real word — allow it at the
                    # kana-spelling price
                    read, acc = _WORDS[s]
                    relax(i + ln, 1.1 - 0.01 * ln, ("word", read, acc))
            elif ln >= 3 and s in _READING_ACCENT:
                # kana spelling of a lexicon word (がっこう for 学校):
                # slightly dearer than a surface match, far cheaper than
                # falling apart into per-character kana. Only ≥3 kana —
                # 2-mora readings (いま, しょう) would steal okurigana from
                # verb stems (会い|ましょう); short kana runs still pick up
                # their accent via the merged-kana _READING_ACCENT lookup.
                # Readings that BEGIN with a topic/object particle char are
                # dearer still, so 対策はした splits into は(わ)+した rather
                # than matching the derived reading はした; a genuine word
                # like はじまる still beats the per-char fallback.
                cost = 1.7 if s[0] in "はへを" else 1.1
                relax(i + ln, cost - 0.01 * ln, ("word", s, _READING_ACCENT[s]))
            if s in _ATTACH:
                # particles/auxiliaries only attach to a preceding phrase
                # head; at chunk start (or after a bare-kana run) the kana
                # belongs to a word (がっこう must not lose its が). back[i]
                # is final here: all edges into i come from positions < i.
                prev = back[i]
                if prev is not None and prev[1][0] in (
                    "word", "attach", "num", "kanji"
                ):
                    relax(i + ln, 0.6, ("attach", _ATTACH[s], None))
        ch = chunk[i]
        if ch.isdigit():
            j = i
            while j < n and chunk[j].isdigit():
                j += 1
            digits = chunk[i:j]
            # decimals arrive as Xてん Y (symbols_to_japanese rewrites the
            # point); read the fraction part digit-by-digit as one token
            if chunk[j:j + 2] == "てん" and j + 2 < n and chunk[j + 2].isdigit():
                k = j + 2
                while k < n and chunk[k].isdigit():
                    k += 1
                frac = "".join(_NUM_KANA[int(d)] for d in chunk[j + 2:k])
                read = _number_to_kana(digits) + "てん" + frac
                if k < n and chunk[k] in _COUNTERS:
                    relax(k + 1, 0.9,
                          ("num", read + _COUNTERS[chunk[k]], None))
                relax(k, 1.0, ("num", read, None))
            # fractions: 2分の1 -> にぶんのいち (not the 分 minutes counter)
            if chunk[j:j + 2] == "分の" and j + 2 < n and chunk[j + 2].isdigit():
                k = j + 2
                while k < n and chunk[k].isdigit():
                    k += 1
                relax(k, 0.9, ("num", _number_to_kana(digits) + "ぶんの"
                               + _number_to_kana(chunk[j + 2:k]), None))
            # mixed arabic+group-kanji numerals (1万, 2600万, 1億2600万):
            # absorb digit/万/億 alternations into one number token
            val, jg = _parse_arabic_grouped(chunk, i)
            if val is not None:
                digits_g = str(val)
                if (jg < n and chunk[jg] in _COUNTERS
                        and chunk[jg] not in _KANJI_GROUP):
                    relax(jg + 1, 1.0, _counter_token(digits_g, chunk[jg]))
                relax(jg, 1.1, ("num", _number_to_kana(digits_g), None))
            if chunk[j:j + 2] in _COUNTERS2 and chunk[i:j + 2] not in _WORDS:
                relax(j + 2, 0.95, _counter_token(digits, chunk[j:j + 2]))
                if chunk[j + 2:j + 3] == "半":  # 2時間半 -> にじかんはん
                    relax(j + 3, 0.93,
                          _counter_token(digits, chunk[j:j + 2], "はん"))
            if j < n and chunk[j] in _COUNTERS and chunk[i:j + 1] not in _WORDS:
                relax(j + 1, 1.0, _counter_token(digits, chunk[j]))
                if chunk[j + 1:j + 2] == "半":  # 3年半 -> さんねんはん
                    relax(j + 2, 0.98,
                          _counter_token(digits, chunk[j], "はん"))
            relax(j, 1.2, ("num", _number_to_kana(digits), None))
        elif _is_kanji(ch):
            val, j = _parse_kanji_number(chunk, i)
            if val is not None and j > i:
                digits = str(val)
                if chunk[j:j + 2] in _COUNTERS2 and chunk[i:j + 2] not in _WORDS:
                    relax(j + 2, 0.95, _counter_token(digits, chunk[j:j + 2]))
                    if chunk[j + 2:j + 3] == "半":  # 二時間半
                        relax(j + 3, 0.93,
                              _counter_token(digits, chunk[j:j + 2], "はん"))
                if (j < n and chunk[j] in _COUNTERS
                        and chunk[i:j + 1] not in _WORDS):
                    relax(j + 1, 1.0, _counter_token(digits, chunk[j]))
                    if chunk[j + 1:j + 2] == "半":  # 三年半
                        relax(j + 2, 0.98,
                              _counter_token(digits, chunk[j], "はん"))
                relax(j, 1.2, ("num", _number_to_kana(digits), None))
            if ch in _CHAR_READINGS:
                relax(i + 1, 1.8, ("kanji", _CHAR_READINGS[ch], None))
            elif ch == "々" and i > 0 and _is_kanji(chunk[i - 1]):
                # generic reduplication: repeat the previous kanji's reading
                # (rendaku'd common pairs have explicit word entries)
                rd = _CHAR_READINGS.get(chunk[i - 1], "")
                relax(i + 1, 2.0 if rd else 3.0, ("kanji", rd, None))
            else:
                relax(i + 1, 3.0, ("kanji", "", None))
        elif _is_kana(ch):
            relax(i + 1, 2.5, ("kana", _katakana_to_hiragana(ch), None))
        else:
            relax(i + 1, 3.0, ("other", ch, None))

    tokens: list[tuple[str, str, int | None]] = []
    j = n
    while j > 0:
        i, tok = back[j]
        tokens.append(tok)
        j = i
    tokens.reverse()
    # merge consecutive unknown-kana characters into one token and give the
    # merged reading a lexicon accent when one exists (せんせい -> 3)
    merged: list[tuple[str, str, int | None]] = []
    for tok in tokens:
        if tok[0] == "kana" and merged and merged[-1][0] == "kana":
            read = merged[-1][1] + tok[1]
            merged[-1] = ("kana", read, _READING_ACCENT.get(read))
        else:
            kind, read, acc = tok
            if kind == "kana":
                acc = _READING_ACCENT.get(read)
            merged.append((kind, read, acc))
    # on-reading juncture sokuon for OOV kanji compounds assembled from
    # per-character fallbacks: 特許 toku+kyo -> tokkyo, 仏教 butsu+kyou ->
    # bukkyou, 物価 butsu+ka -> bukka (pyopenjtalk resolves these through
    # NAIST-jdic; the fallback applies the productive phonological rule,
    # reference text/japanese.py:36-49 only rewrites already-written っ)
    for k in range(len(merged) - 1):
        a, b = merged[k], merged[k + 1]
        # numeral + kanji also forms a Sino juncture (一般 ichi+han ->
        # ippan, 六感 roku+kan -> rokkan); counters already consumed the
        # regular numeral+counter cases upstream
        if a[0] in ("kanji", "num") and b[0] == "kanji":
            gem = _geminate_on_juncture(a[1], b[1])
            if gem is not None:
                merged[k] = (a[0], gem[0], a[2])
                merged[k + 1] = ("kanji", gem[1], b[2])
    return merged


def _geminate_on_juncture(a: str, b: str) -> tuple[str, str] | None:
    """Sokuon rule at a Sino-Japanese compound juncture.

    Fires only when the first element looks like an on-reading (<= 2 moras)
    ending in く/き/つ/ち:
      * く/き assimilate before the k-row only (学校 gakkou, 石器 sekki);
        before s/t rows they stay (育成 ikusei, 直接 chokusetsu)
      * つ/ち assimilate before k/s/t rows (発見 hakken, 発生 hassei,
        決定 kettei) and before the h-row with h->p fortition
        (出発 shuppatsu, 一杯 ippai)
    """
    if not a or not b:
        return None
    if len(_kana_moras(a)) > 2:  # 3+ moras: likely a kun reading (みがく)
        return None
    last, first = a[-1], b[0]
    if last in "くき" and first in "かきくけこ":
        return a[:-1] + "っ", b
    if last in "つち":
        if first in "かきくけこさしすせそたちつてと":
            return a[:-1] + "っ", b
        if first in _H_TO_P:
            return a[:-1] + "っ", _H_TO_P[first] + b[1:]
    return None


# て/で + い-initial subsidiary verb inside a raw kana run (ている/ていく/
# ていただく/...): a morpheme boundary the long-vowel rules must not merge
# across. Sino-Japanese てい words (ていど, ていねい) continue with moras
# outside this set and keep the merge.
_TE_I_BOUNDARY = re.compile(
    r"([てで])(い(?:る|れば|ます|まし|ませ|た|て|な|き(?![ゃゅょ])|く|ただ|らっしゃ|う))"
)

# attach readings concatenate raw into the phrase string, so a て/で + い-aux
# inside them (させて+いただきます chains) needs the same boundary sentinel
# the kana-run path gets; already-marked values ("されて|います") no-op here
for _k, _v in list(_ATTACH.items()):
    _ATTACH[_k] = _TE_I_BOUNDARY.sub(r"\1|\2", _v)


def _assemble_phrases(
    tokens: list[tuple[str, str, int | None]]
) -> list[tuple[str, int]]:
    """Group tokens into accent phrases: a head word plus trailing
    particles/auxiliaries (openjtalk's accent-phrase segmentation, realized
    from the lexicon); the phrase accent is the head word's nucleus."""
    phrases: list[tuple[str, int]] = []
    cur = ""
    cur_acc: int | None = None
    prev_kind = ""

    def flush():
        nonlocal cur, cur_acc
        if cur:
            phrases.append((cur, cur_acc if cur_acc is not None else 0))
        cur, cur_acc = "", None

    # auxiliaries that fuse with a preceding te-form into one accent phrase
    # (待って + います -> まっています, openjtalk keeps these together)
    _TE_AUX = (
        "いる", "います", "いました", "いた", "いて", "いない", "いません",
        "ある", "あります", "ありました", "おく", "おきます", "しまう",
        "しまいます", "しまった", "しまいました", "しまって", "みる",
        "みます", "ください", "くる",
        "きます", "きた", "いく", "いきます",
        "いう", "いうか",  # quotative って+いう (boundary stops the ee merge)
    )

    for kind, read, acc in tokens:
        if not read:
            continue
        if kind == "kana":
            # raw inflection tails: mark the て/で|auxiliary morpheme
            # boundary so the ei->ee long-vowel merge (Sino-Japanese
            # morpheme-internal, 経済 -> keezai) does not fire across it
            # (しています must stay "shiteimasu", ていただけます "teitadake")
            read = _TE_I_BOUNDARY.sub(r"\1|\2", read)
        if kind == "attach" and cur:
            if cur.endswith(("て", "で")) and read.startswith("い"):
                # te-form + い-initial auxiliary join (教えて+いただけます):
                # morpheme boundary so the ei->ee merge cannot fire
                cur += "|" + read
            else:
                cur += read
        elif kind == "kanji" and cur and prev_kind in ("word", "kanji", "num"):
            cur += read  # unknown compound continues the phrase
        elif kind == "kana" and cur and prev_kind not in ("", "attach"):
            cur += read  # okurigana / inflection tail
        elif (kind == "word" and cur and cur.endswith(("て", "で"))
              and read in _TE_AUX):
            cur += "|" + read  # te-form + auxiliary verb: one accent phrase
        elif (kind in ("word", "kanji") and cur in ("お", "ご")
              and prev_kind == "kana"):
            # honorific prefix: お名前/ご連絡 form one accent phrase; the
            # prefix adds one mora before the word's nucleus
            cur += read
            cur_acc = (acc + 1 if acc else acc) if acc is not None else None
        else:
            flush()
            cur, cur_acc = read, acc
        prev_kind = kind
    flush()
    return phrases


def _kana_moras(kana: str) -> list[str]:
    """Hiragana -> mora units (yoon digraphs merge; っ/ん/ー each count)."""
    moras: list[str] = []
    i = 0
    while i < len(kana):
        if kana[i : i + 2] in _KANA_YOON:
            moras.append(kana[i : i + 2])
            i += 2
        else:
            moras.append(kana[i])
            i += 1
    return moras


def _mora_to_romaji(mora: str, out_so_far: str) -> str:
    """One mora -> romaji, context-sensitive for long vowels (accent arrows
    are transparent to the vowel context)."""
    ctx = out_so_far.replace("↑", "").replace("↓", "")
    if mora == "|":
        return "|"  # morpheme boundary: blocks the long-vowel context
    if mora in _KANA_YOON:
        return _KANA_YOON[mora]
    if mora == "っ":
        return "Q"
    if mora == "う" and ctx.endswith("o"):
        return "o"  # orthographic long vowel (ou -> oo)
    if mora == "い" and ctx.endswith("e"):
        return "e"  # orthographic long vowel (ei -> ee)
    if mora == "ー":
        return ctx[-1] if ctx and ctx[-1] in "aiueo" else ""
    return _KANA_BASE.get(mora, mora)


def _kana_to_romaji(text: str, accent: bool = False) -> str:
    """Kana -> openjtalk-style romaji (Q sokuon, N hatsuon); with
    accent=True, insert the ↑/↓ arrows per the module docstring."""
    text = _katakana_to_hiragana(text)
    for k, v in _KANA_EXCEPTIONS.items():
        text = text.replace(k, v)
    if not accent:
        moras = _kana_moras(text)
        out = ""
        for mora in moras:
            out += _mora_to_romaji(mora, out)
        return out.replace("|", "")
    nucleus = _READING_ACCENT.get(text, 0)
    return _phrase_to_romaji(text, nucleus)


def _phrase_to_romaji(kana: str, nucleus: int) -> str:
    """One accent phrase (reading in hiragana) -> romaji with ↑/↓ arrows per
    the module docstring rules."""
    moras = _kana_moras(kana)
    n_moras = sum(1 for m in moras if m != "|")
    out = ""
    idx = 0
    for mora in moras:
        if mora == "|":
            out += "|"  # boundary sentinel: not a mora, stripped below
            continue
        idx += 1
        out += _mora_to_romaji(mora, out)
        if idx >= n_moras:
            continue  # phrase-final: no following mora, no audible arrow
        if nucleus == idx:
            out += "↓"
        elif idx == 1 and nucleus != 1:
            out += "↑"
    return out.replace("|", "")


# latin letters read as Japanese letter names (OpenJTalk reads "ABC" as
# エービーシー; without this the fallback leaked raw A-Z into the IPA
# stream, where the symbol filter silently dropped them)
_LATIN_KANA = {
    "A": "エー", "B": "ビー", "C": "シー", "D": "ディー", "E": "イー",
    "F": "エフ", "G": "ジー", "H": "エイチ", "I": "アイ", "J": "ジェー",
    "K": "ケー", "L": "エル", "M": "エム", "N": "エヌ", "O": "オー",
    "P": "ピー", "Q": "キュー", "R": "アール", "S": "エス", "T": "ティー",
    "U": "ユー", "V": "ブイ", "W": "ダブリュー", "X": "エックス",
    "Y": "ワイ", "Z": "ゼット",
}
_LATIN_RUN = re.compile(r"[A-Za-z]+")


def _fallback_sentence_to_romaji(sentence: str) -> str:
    """Mixed kanji/kana/digit text -> accent-phrase romaji, the openjtalk
    role (reference japanese.py:58-108) realized from the vendored lexicon:
    segment (kanji_dict longest-match DP), group into accent phrases,
    read particles (は->わ, へ->え, を->お) and numbers, emit arrows.
    Accent phrases are space-separated, as the full-context path does."""
    # full-width latin/digits (Ｗｏｗ, ＳＵＳＨＩ — common in VN text) fold
    # to ASCII so the letter-name and number rules see them
    sentence = "".join(
        chr(ord(c) - 0xFEE0) if 0xFF01 <= ord(c) <= 0xFF5E else c
        for c in sentence
    )
    sentence = _LATIN_RUN.sub(
        lambda m: "".join(_LATIN_KANA[c] for c in m.group(0).upper()),
        sentence,
    )
    phrases = _assemble_phrases(_segment(sentence))
    return " ".join(
        _phrase_to_romaji(kana, nucleus) for kana, nucleus in phrases
    )


def japanese_to_kana(text: str) -> str:
    """Accent-free hiragana reading, space-separated by accent phrase.

    A probe/debug surface over the same segmentation + lexicon the fallback
    g2p uses (tests/fixtures/ja_oov_fixture.json measures mora accuracy on
    held-out text through this)."""
    text = symbols_to_japanese(text)
    sentences = re.split(_japanese_marks, text)
    out: list[str] = []
    for sentence in sentences:
        if not re.match(_japanese_characters, sentence):
            continue
        sentence = "".join(
            chr(ord(c) - 0xFEE0) if 0xFF01 <= ord(c) <= 0xFF5E else c
            for c in sentence
        )
        sentence = _LATIN_RUN.sub(
            lambda m: "".join(_LATIN_KANA[c] for c in m.group(0).upper()),
            sentence,
        )
        phrases = _assemble_phrases(_segment(sentence))
        out.append(" ".join(k.replace("|", "") for k, _ in phrases))
    return " ".join(out)


def symbols_to_japanese(text: str) -> str:
    for regex, replacement in _SYMBOLS_TO_JAPANESE:
        text = regex.sub(replacement, text)
    return text


def _openjtalk_available() -> bool:
    try:
        import pyopenjtalk  # noqa: F401

        return True
    except ImportError:
        return False


# non-Japanese marks -> ASCII, the role unidecode plays in the reference
# (japanese.py:106: `unidecode(marks[i])`)
_MARKS_TRANSLIT = str.maketrans({
    "、": ",", "。": ".", "！": "!", "？": "?", "，": ",", "．": ".",
    "・": ",", "：": ",", "；": ",", "〜": "~", "～": "~", "…": "…",
    "「": "", "」": "", "『": "", "』": "", "（": "", "）": "",
    "“": "", "”": "", "‘": "", "’": "", "　": "",
})


def _translit_marks(marks: str) -> str:
    out = marks.translate(_MARKS_TRANSLIT).replace(" ", "")
    return "".join(ch for ch in out if ord(ch) < 0x2E80 or ch == "…")


def japanese_to_romaji_with_accent(text: str) -> str:
    """Full-context-label path with pitch-accent arrows
    (reference japanese.py:58-108); the kana fallback realizes accents from
    the lexicon + heiban default."""
    text = symbols_to_japanese(text)
    sentences = re.split(_japanese_marks, text)
    marks = re.findall(_japanese_marks, text)

    use_ojt = _openjtalk_available()
    out = ""
    for i, sentence in enumerate(sentences):
        if re.match(_japanese_characters, sentence):
            if out != "":
                out += " "
            if use_ojt:
                out += _romaji_accent_openjtalk(sentence)
            else:
                out += _fallback_sentence_to_romaji(sentence)
        if i < len(marks):
            out += _translit_marks(marks[i])
    return out


def _romaji_accent_openjtalk(sentence: str) -> str:  # pragma: no cover
    """Pitch accent from full-context labels (reference japanese.py:75-103)."""
    import pyopenjtalk

    text = ""
    labels = pyopenjtalk.extract_fullcontext(sentence)
    for n, label in enumerate(labels):
        phoneme = re.search(r"\-([^\+]*)\+", label).group(1)
        if phoneme in ("sil", "pau"):
            continue
        text += phoneme.replace("ch", "ʧ").replace("sh", "ʃ").replace("cl", "Q")
        a1 = int(re.search(r"/A:(\-?[0-9]+)\+", label).group(1))
        a2 = int(re.search(r"\+(\d+)\+", label).group(1))
        a3 = int(re.search(r"\+(\d+)/", label).group(1))
        if re.search(r"\-([^\+]*)\+", labels[n + 1]).group(1) in ("sil", "pau"):
            a2_next = -1
        else:
            a2_next = int(re.search(r"\+(\d+)\+", labels[n + 1]).group(1))
        if a3 == 1 and a2_next == 1:
            text += " "
        elif a1 == 0 and a2_next == a2 + 1:
            text += "↓"
        elif a2 == 1 and a2_next == 2:
            text += "↑"
    return text


def get_real_sokuon(text: str) -> str:
    for regex, replacement in _REAL_SOKUON:
        text = regex.sub(replacement, text)
    return text


def get_real_hatsuon(text: str) -> str:
    for regex, replacement in _REAL_HATSUON:
        text = regex.sub(replacement, text)
    return text


def japanese_to_ipa(text: str) -> str:
    """Main entry (reference japanese.py:123-131)."""
    text = japanese_to_romaji_with_accent(text).replace("...", "…")
    text = get_real_sokuon(text)
    text = get_real_hatsuon(text)
    for regex, replacement in _ROMAJI_TO_IPA:
        text = regex.sub(replacement, text)
    return text
