"""Chinese non-standard-word (NSW) text normalization.

Behavioral reference: reference text/frontend/zh_normalization/ (the
PaddleSpeech normalizer): sentence split, full->half width (ASCII letters,
digits and ideographic space only), then regex verbalizers applied in a
fixed order — dates, time (+ranges), temperature, fractions, percentages,
mobile/landline/400 phone numbers, ranges, negative numbers, decimals,
number+measure-word, bare digit strings, plain numbers
(text_normlization.py:86-110). The verbalizers mirror num.py /
chronology.py / phonecode.py / quantifier.py semantics exactly (verified by
the fixture test tests/fixtures/zh_norm_fixture.json generated by running
the reference normalizer offline); the number core is the dependency-free
an2cn from vits_tpu.text.numbers.

One documented deviation: the reference splits sentences on every ASCII
'.' including decimal points (text_normlization.py:54 — "25.5元" becomes
"25." / "5元"); here a '.' followed by a digit is kept as a decimal point.
The fixture test compares per-sentence outputs, so this improvement is
exercised separately in tests/test_zh_normalization.py.
"""

from __future__ import annotations

import re
import string

from perfbench.reference.text.numbers import an2cn, _ZH_DIGITS

# -- full-width -> half-width tables (reference constants.py:20-40) ---------
# Scope matches the reference: ASCII letters, digits, ideographic space.
# Full-width punctuation is intentionally left alone (the sentence splitter
# keys on it).

F2H = {chr(ord(c) + 0xFEE0): c for c in string.ascii_letters + string.digits}
F2H[chr(0x3000)] = " "
_F2H_TABLE = str.maketrans(F2H)


def full_to_half(text: str) -> str:
    return text.translate(_F2H_TABLE)


# -- number core (reference num.py:168-238) ---------------------------------


def _verbalize_digit(s: str, alt_one: bool = False) -> str:
    """Digit-by-digit reading; alt_one reads 1 as 幺 (phone style)."""
    out = "".join(_ZH_DIGITS[int(c)] if c.isdigit() else c for c in s)
    return out.replace("一", "幺") if alt_one else out


def num2str(s: str) -> str:
    """Cardinal reading with decimal part digit-by-digit.

    Matches reference num2str (num.py:213-238): trailing zeros of the
    decimal part are dropped ('3.20' -> 三点二), a pure decimal keeps a
    leading 零 ('.22' -> 零点二二).
    """
    int_part, _, dec_part = s.partition(".")
    result = an2cn(int_part) if int_part else ""
    dec_part = dec_part.rstrip("0")
    if dec_part:
        result = result or "零"
        result += "点" + _verbalize_digit(dec_part)
    return result


def _time_num2str(s: str) -> str:
    """Time minute/second reading: leading zero spoken (chronology.py:22-27)."""
    result = num2str(s.lstrip("0") or "0")
    if s.startswith("0"):
        result = "零" + result
    return result


# -- chronology (reference chronology.py) -----------------------------------

RE_DATE = re.compile(
    r"(\d{4}|\d{2})年"
    r"((0?[1-9]|1[0-2])月)?"
    r"(((0?[1-9])|((1|2)[0-9])|30|31)([日号]))?"
)


def _replace_date(m: re.Match) -> str:
    out = ""
    if m.group(1):
        out += _verbalize_digit(m.group(1)) + "年"
    if m.group(3):
        out += an2cn(m.group(3)) + "月"
    if m.group(5):
        out += an2cn(m.group(5)) + m.group(9)
    return out


RE_DATE2 = re.compile(
    r"(\d{4})([- /.])(0[1-9]|1[012])\2(0[1-9]|[12][0-9]|3[01])"
)


def _replace_date2(m: re.Match) -> str:
    return (
        _verbalize_digit(m.group(1)) + "年"
        + an2cn(m.group(3)) + "月"
        + an2cn(m.group(4)) + "日"
    )


RE_TIME = re.compile(r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?")
RE_TIME_RANGE = re.compile(
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
    r"[~-]"
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
)


def _one_time(hour: str, minute: str, second: str | None,
              half_check_minute: str) -> str:
    out = num2str(hour) + "点"
    if minute.lstrip("0"):
        # Quirk kept from the reference (chronology.py:66-79): in a time
        # range the second clock's 半-check reads the FIRST clock's minute.
        if int(half_check_minute) == 30:
            out += "半"
        else:
            out += _time_num2str(minute) + "分"
    if second and second.lstrip("0"):
        out += _time_num2str(second) + "秒"
    return out


def _replace_time(m: re.Match) -> str:
    g = m.groups()
    out = _one_time(g[0], g[1], g[3], g[1])
    if len(g) > 5:
        out += "至" + _one_time(g[4], g[5], g[7], g[1])
    return out


# -- temperature (reference quantifier.py:21-37) ----------------------------

RE_TEMPERATURE = re.compile(r"(-?)(\d+(\.\d+)?)(°C|℃|度|摄氏度)")


def _replace_temperature(m: re.Match) -> str:
    sign = "零下" if m.group(1) else ""
    # Quirk kept from the reference (quantifier.py:31-36): the unit check
    # reads group(3) — the decimal-part group, never the unit (group 4) —
    # so every temperature reads as 度, including an explicit 摄氏度.
    # This is byte-identical to the reference's executed behaviour
    # (its "摄氏度" branch at quantifier.py:35 is dead code); proven by
    # tests/test_zh_normalization.py::
    # test_temperature_differential_vs_reference_code, which runs the
    # reference's own replace_temperature side by side.
    return sign + num2str(m.group(2)) + "度"


# -- fractions / percentages (reference num.py:36-74) -----------------------

RE_FRAC = re.compile(r"(-?)(\d+)/(\d+)")


def _replace_frac(m: re.Match) -> str:
    sign = "负" if m.group(1) else ""
    return sign + num2str(m.group(3)) + "分之" + num2str(m.group(2))


RE_PERCENTAGE = re.compile(r"(-?)(\d+(\.\d+)?)%")


def _replace_percentage(m: re.Match) -> str:
    sign = "负" if m.group(1) else ""
    return sign + "百分之" + num2str(m.group(2))


# -- phone numbers (reference phonecode.py) ---------------------------------

RE_MOBILE_PHONE = re.compile(
    r"(?<!\d)((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})(?!\d)"
)
RE_TELEPHONE = re.compile(
    r"(?<!\d)((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{7,8})(?!\d)"
)
RE_NATIONAL_UNIFORM_NUMBER = re.compile(r"(400)(-)?\d{3}(-)?\d{4}")


def _replace_mobile(m: re.Match) -> str:
    parts = m.group(0).strip("+").split()
    return "，".join(_verbalize_digit(p, alt_one=True) for p in parts)


def _replace_phone(m: re.Match) -> str:
    parts = m.group(0).split("-")
    return "，".join(_verbalize_digit(p, alt_one=True) for p in parts)


# -- ranges / plain numbers (reference num.py:77-165) -----------------------

RE_NUMBER = re.compile(r"(-?)((\d+)(\.\d+)?)|(\.(\d+))")


def _replace_number(m: re.Match) -> str:
    if m.group(5):  # pure decimal .22
        return num2str(m.group(5))
    sign = "负" if m.group(1) else ""
    return sign + num2str(m.group(2))


RE_RANGE = re.compile(
    r"((-?)((\d+)(\.\d+)?)|(\.(\d+)))[-~]((-?)((\d+)(\.\d+)?)|(\.(\d+)))"
)


def _replace_range(m: re.Match) -> str:
    first = RE_NUMBER.sub(_replace_number, m.group(1))
    second = RE_NUMBER.sub(_replace_number, m.group(8))
    return first + "到" + second


RE_INTEGER = re.compile(r"(-)(\d+)")


def _replace_negative(m: re.Match) -> str:
    return "负" + num2str(m.group(2))


RE_DECIMAL = re.compile(r"(-?)((\d+)(\.\d+))|(\.(\d+))")


# number + measure word (reference num.py COM_QUANTIFIERS, the full
# inventory — the reading is a plain cardinal, 2个 -> 二个, matching the
# reference's replace_positive_quantifier)
COM_QUANTIFIERS = (
    "(所|朵|匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|"
    "壳|窠|曲|墙|群|腔|砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|单|"
    "双|对|出|口|头|脚|板|跳|枝|件|贴|针|线|管|名|位|身|堂|课|本|页|家|户|层|丝|"
    "毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|毫|厘|(公)分|分|寸|尺|丈|"
    "里|寻|常|铺|程|(千|分|厘|毫|微)米|米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|"
    "盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|"
    "时|周|天|秒|分|小时|旬|纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|"
    "堆|条|根|支|道|面|片|张|颗|块|元|(亿|千万|百万|万|千|百)|(亿|千万|百万|万|"
    "千|百|美|)元|(亿|千万|百万|万|千|百|)块|角|毛|分)"
)
RE_POSITIVE_QUANTIFIER = re.compile(r"(\d+)([多余几\+])?" + COM_QUANTIFIERS)


def _replace_quantifier(m: re.Match) -> str:
    suffix = m.group(2) or ""
    if suffix == "+":
        suffix = "多"
    return num2str(m.group(1)) + suffix + m.group(3)


# bare >=3-digit strings left over (serial numbers): digit-by-digit
RE_DEFAULT_NUM = re.compile(r"\d{3}\d*")


def _replace_default_num(m: re.Match) -> str:
    return _verbalize_digit(m.group(0))


# Deviation from reference text_normlization.py:54: an ASCII '.' followed by
# a digit is a decimal point (5.5度), not a sentence boundary — the reference
# splits mid-number there.
SENTENCE_SPLITOR = re.compile(r"([：、，；。？！,;?!…][”’]?|\.(?!\d)[”’]?)")


class TextNormalizer:
    """Sentence split + ordered NSW verbalization
    (reference text_normlization.py:50-110)."""

    def split(self, text: str) -> list[str]:
        text = text.replace(" ", "")
        text = re.sub(r"[《》【】<=>{}()（）&@“”^_|\\]", "", text)
        text = SENTENCE_SPLITOR.sub(r"\1\n", text).strip()
        return [s.strip() for s in re.split(r"\n+", text) if s.strip()]

    def normalize_sentence(self, sentence: str) -> str:
        # trad->simp here as well as in zh_frontend (idempotent) so this
        # class alone matches reference normalize_sentence byte for byte.
        from perfbench.reference.text.char_convert import traditional_to_simplified

        sentence = traditional_to_simplified(sentence)
        sentence = full_to_half(sentence)
        # ideographic zero: the reference survives 〇 through its char
        # tables and pypinyin reads it as líng; our pinyin lexicon keys 零,
        # so rewrite before verbalization (二〇二三年, phone digits)
        sentence = sentence.replace("〇", "零").replace("○", "零")
        sentence = RE_DATE.sub(_replace_date, sentence)
        sentence = RE_DATE2.sub(_replace_date2, sentence)
        sentence = RE_TIME_RANGE.sub(_replace_time, sentence)
        sentence = RE_TIME.sub(_replace_time, sentence)
        sentence = RE_TEMPERATURE.sub(_replace_temperature, sentence)
        sentence = RE_FRAC.sub(_replace_frac, sentence)
        sentence = RE_PERCENTAGE.sub(_replace_percentage, sentence)
        sentence = RE_MOBILE_PHONE.sub(_replace_mobile, sentence)
        sentence = RE_TELEPHONE.sub(_replace_phone, sentence)
        sentence = RE_NATIONAL_UNIFORM_NUMBER.sub(_replace_phone, sentence)
        sentence = RE_RANGE.sub(_replace_range, sentence)
        sentence = RE_INTEGER.sub(_replace_negative, sentence)
        sentence = RE_DECIMAL.sub(_replace_number, sentence)
        sentence = RE_POSITIVE_QUANTIFIER.sub(_replace_quantifier, sentence)
        sentence = RE_DEFAULT_NUM.sub(_replace_default_num, sentence)
        sentence = RE_NUMBER.sub(_replace_number, sentence)
        sentence = sentence.replace("/", "每").replace("~", "至")
        return sentence

    def normalize(self, text: str) -> str:
        return "".join(self.normalize_sentence(s) for s in self.split(text))
