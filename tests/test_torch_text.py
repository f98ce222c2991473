"""The port's text frontend (its own copy of ``vits_tpu/text``) against the
JAX package's, on the same tagged strings: IPA string, symbol ids and
language ids must be equal exactly. Run with jieba as installed and with
jieba hidden on both sides (the machine with the card has no jieba, so its
greedy lexicon fallback runs there). Also: the copied data tables equal the
JAX package's, the modules differ from the JAX package's only in their
import lines and in how they cite the reference implementation, and
importing the port's text package does not import jieba.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

from vits_torch import text as ttext
from vits_torch.ops.commons import intersperse_with_language_id
from vits_torch.text import char_convert, cleaners, en_dict, kanji_dict, pinyin_dict, pinyin_tail
from vits_torch.text import english, japanese, mandarin, numbers, zh_normalization

import vits_tpu.text as jtext
from vits_tpu.ops.commons import intersperse_with_language_id as j_intersperse
from vits_tpu.text import char_convert as jchar_convert, cleaners as jcleaners
from vits_tpu.text import en_dict as jen_dict, kanji_dict as jkanji_dict
from vits_tpu.text import english as jenglish, japanese as jjapanese, mandarin as jmandarin
from vits_tpu.text import numbers as jnumbers, zh_normalization as jzh_normalization
from vits_tpu.text import pinyin_dict as jpinyin_dict, pinyin_tail as jpinyin_tail

ROOT = Path(__file__).resolve().parent.parent

STRINGS = [
    # Mandarin: plain, tone sandhi (3-3, 一, 不), erhua, traditional, numbers
    "[ZH]你好，世界。[ZH]",
    "[ZH]我们一起去北京吧！你买不买？不要不好意思。[ZH]",
    "[ZH]这儿有一个小孩儿在玩儿，老李也很好。[ZH]",
    "[ZH]這是繁體中文的測試，請說國語。[ZH]",
    "[ZH]2024年3月15日，气温是-3.5度，价格为12.50元，电话13812345678。[ZH]",
    "[ZH]“你好！”他说：‘再见……’[ZH]",
    # raw pinyin
    "[P]ni3#hao3 shi4#jie4%[P]",
    # Japanese: kana, kanji, punctuation
    "[JA]こんにちは、世界。[JA]",
    "[JA]カタカナとひらがな、ありがとう！[JA]",
    "[JA]東京は日本の首都です。今日は良い天気ですね？[JA]",
    # English: numbers, acronyms, OOV words, punctuation
    "[EN]Hello world, it's 3 PM.[EN]",
    "[EN]The NASA and FBI agents met at 10:30 on Jan. 5th, 1999.[EN]",
    "[EN]Supercalifragilistic flibbertigibbet zorbulates quixotically.[EN]",
    "[EN]I paid $12.50 for 3 books... what?! (Really) - yes; no.[EN]",
    # mixed, and untagged text that is dropped
    "[ZH]今天[ZH][EN]good morning[EN][JA]ありがとう[JA][P]zai4#jian4[P]",
    "untagged text [EN]hello there[EN] more untagged [ZH]谢谢[ZH] tail",
]


@pytest.fixture(params=["jieba installed", "jieba hidden"])
def jieba_mode(request, monkeypatch):
    if request.param == "jieba hidden":
        monkeypatch.setitem(sys.modules, "jieba", None)
        monkeypatch.setitem(sys.modules, "jieba.posseg", None)
    return request.param


@pytest.mark.parametrize("s", STRINGS)
def test_clean_text_matches_jax(jieba_mode, s):
    ipa, lang = cleaners.clean_text(s)
    ref_ipa, ref_lang = jcleaners.clean_text(s)
    assert ipa == ref_ipa
    assert lang == ref_lang
    ids = ttext.cleaned_text_to_sequence(ipa)
    assert ids == jtext.cleaned_text_to_sequence(ref_ipa)
    assert ttext.sequence_to_text(ids) == ipa
    assert cleaners.text_to_sequence(s) == jcleaners.text_to_sequence(s)
    if ids:
        blanked = intersperse_with_language_id(ids, lang, 0)
        assert blanked == j_intersperse(ids, ref_lang, 0)


def test_jieba_hidden_changes_only_the_segmenter(monkeypatch):
    """Hiding jieba reaches the copied frontend: the segmenter falls back
    to the lexicon on both sides and still agrees."""
    s = "[ZH]我们一起去北京吧！[ZH]"
    monkeypatch.setitem(sys.modules, "jieba", None)
    monkeypatch.setitem(sys.modules, "jieba.posseg", None)
    from vits_tpu.text import zh_frontend as jzh
    from vits_torch.text import zh_frontend as zh

    assert zh._segment("我们一起去北京") == jzh._segment("我们一起去北京")
    assert cleaners.clean_text(s) == jcleaners.clean_text(s)


@pytest.mark.parametrize("word", ["hello", "nation", "xylophone", "brrrk", "quintessential"])
def test_english_to_ipa_matches_jax(word):
    assert english.english_to_ipa(word) == jenglish.english_to_ipa(word)


@pytest.mark.parametrize("s", ["きょうはいいてんき", "東京タワー", "がっこう、ありがとう。"])
def test_japanese_to_ipa_matches_jax(s):
    assert japanese.japanese_to_ipa(s) == jjapanese.japanese_to_ipa(s)


@pytest.mark.parametrize("s", ["你好", "一个人", "2023年", "老鼠儿"])
def test_chinese_to_ipa_matches_jax(jieba_mode, s):
    assert mandarin.chinese_to_ipa(s) == jmandarin.chinese_to_ipa(s)


def test_numbers_and_normalizer_match_jax():
    for s in ("I have 21 cats and $3.50.", "1st 2nd 3rd 1,234,567", "in 1999 at 10:30"):
        assert numbers.normalize_numbers_en(s) == jnumbers.normalize_numbers_en(s)
    for n in ("0", "10", "101", "12345", "3.14"):
        assert numbers.an2cn(n) == jnumbers.an2cn(n)
    s = "今天是2024年3月15日，温度-3°C，比分2:1，占比50%。"
    assert (zh_normalization.TextNormalizer().normalize(s)
            == jzh_normalization.TextNormalizer().normalize(s))


def test_data_tables_equal_jax():
    assert en_dict.WORDS == jen_dict.WORDS
    assert kanji_dict.WORDS == jkanji_dict.WORDS
    assert kanji_dict.CHARS == jkanji_dict.CHARS
    assert pinyin_dict.PHRASE_TO_PINYIN == jpinyin_dict.PHRASE_TO_PINYIN
    assert pinyin_dict.CHAR_TO_PINYIN == jpinyin_dict.CHAR_TO_PINYIN
    assert pinyin_tail.TAIL_READINGS == jpinyin_tail.TAIL_READINGS
    assert char_convert.T2S == jchar_convert.T2S
    assert char_convert.S2T == jchar_convert.S2T
    assert len(char_convert.T2S) > 10000


_IMPORT = re.compile(r"^(\s*)(from|import) vits_tpu\.")
# the JAX modules cite the reference implementation by its checkout's
# absolute path; the copies cite it as "reference <file>"
_CITE = re.compile(r"/[a-z]+/reference/")


@pytest.mark.parametrize("path", sorted((ROOT / "vits_tpu" / "text").glob("*.py")),
                         ids=lambda p: p.name)
def test_copy_differs_only_in_imports(path):
    """Each module is the JAX package's, byte for byte, but for its
    ``vits_tpu.`` imports and its citations of the reference
    (``symbols.py`` was copied earlier with its own docstring; its table is
    checked by the isolation test)."""
    port = ROOT / "vits_torch" / "text" / path.name
    if path.name == "symbols.py":
        assert port.read_text().split('"""')[2] == path.read_text().split('"""')[2]
        return
    want = [_CITE.sub("reference ", _IMPORT.sub(r"\1\2 vits_torch.", line))
            for line in path.read_text().splitlines(keepends=True)]
    assert port.read_text().splitlines(keepends=True) == want


def test_importing_the_text_package_loads_no_jieba():
    code = (
        "import importlib, pkgutil, sys, vits_torch.text\n"
        "for m in pkgutil.walk_packages(vits_torch.text.__path__, 'vits_torch.text.'):\n"
        "    importlib.import_module(m.name)\n"
        "import vits_torch.serve.engine\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jieba', 'pyopenjtalk'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
