"""Number verbalization, dependency-free.

The reference uses `inflect` for English (text/frontend/normalizer/
numbers.py:28-86) and `cn2an` for Chinese (text/mandarin.py:100-104); both
are reimplemented here in pure python so the frontend has no hard external
deps.
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# English
# ---------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = ["", " thousand", " million", " billion", " trillion"]


def _three_digits(n: int) -> str:
    out = []
    if n >= 100:
        out.append(_ONES[n // 100] + " hundred")
        n %= 100
    if n >= 20:
        t = _TENS[n // 10]
        if n % 10:
            t += " " + _ONES[n % 10]
        out.append(t)
    elif n > 0:
        out.append(_ONES[n])
    return " ".join(out)


def number_to_words(n: int) -> str:
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + number_to_words(-n)
    parts = []
    group = 0
    while n > 0:
        n, rem = divmod(n, 1000)
        if rem:
            parts.append(_three_digits(rem) + _SCALES[group])
        group += 1
    return " ".join(reversed(parts))


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _ordinal_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_SPECIAL:
        last = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last += "th"
    return (head + " " + last).strip()


def _expand_decimal(m):
    int_part, frac = m.group(1).split(".")
    return (
        number_to_words(int(int_part))
        + " point "
        + " ".join(number_to_words(int(d)) for d in frac)
    )


def _expand_dollars(m):
    match = m.group(1).replace(",", "")
    parts = match.split(".")
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1][:2].ljust(2, "0")) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return (
            f"{number_to_words(dollars)} dollar{'s' if dollars != 1 else ''}, "
            f"{number_to_words(cents)} cent{'s' if cents != 1 else ''}"
        )
    if dollars:
        return f"{number_to_words(dollars)} dollar{'s' if dollars != 1 else ''}"
    if cents:
        return f"{number_to_words(cents)} cent{'s' if cents != 1 else ''}"
    return "zero dollars"


def _expand_number(m):
    n = int(m.group(0))
    # year-style reading (reference numbers.py:60-73 via inflect year grouping)
    if 1000 < n < 3000:
        if n == 2000:
            return "two thousand"
        if 2000 < n < 2010:
            return "two thousand " + number_to_words(n % 100)
        if n % 100 == 0:
            return number_to_words(n // 100) + " hundred"
        hi, lo = divmod(n, 100)
        joiner = " oh " if lo < 10 else " "
        return number_to_words(hi) + joiner + number_to_words(lo)
    return number_to_words(n)


def normalize_numbers_en(text: str) -> str:
    """English number normalization (reference normalizer/numbers.py:28-86)."""
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(_expand_decimal, text)
    text = _ordinal_re.sub(lambda m: _ordinal_words(int(m.group(1))), text)
    text = _number_re.sub(_expand_number, text)
    return text


# ---------------------------------------------------------------------------
# Chinese (an2cn equivalent)
# ---------------------------------------------------------------------------

_ZH_DIGITS = "零一二三四五六七八九"
_ZH_UNITS = ["", "十", "百", "千"]
_ZH_GROUPS = ["", "万", "亿", "万亿"]


def _an2cn_int(s: str) -> str:
    n = int(s)
    if n == 0:
        return "零"
    groups = []
    while n > 0:
        n, rem = divmod(n, 10000)
        groups.append(rem)
    out = ""
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            if out and not out.endswith("零"):
                out += "零"
            continue
        part = ""
        need_zero = False
        for ui in range(3, -1, -1):
            d = (g // 10**ui) % 10
            if d == 0:
                if part:
                    need_zero = True
            else:
                if need_zero:
                    part += "零"
                    need_zero = False
                part += _ZH_DIGITS[d] + _ZH_UNITS[ui]
        if gi == len(groups) - 1 and part.startswith("一十"):
            part = part[1:]  # 10-19: 十三 not 一十三
        out += part + _ZH_GROUPS[gi]
    out = out.rstrip("零")
    return out or "零"


def an2cn(s: str) -> str:
    """Arabic numeral string -> Chinese reading (cn2an.an2cn equivalent)."""
    if "." in s:
        int_part, frac = s.split(".", 1)
        return (
            _an2cn_int(int_part)
            + "点"
            + "".join(_ZH_DIGITS[int(d)] for d in frac if d.isdigit())
        )
    return _an2cn_int(s)
