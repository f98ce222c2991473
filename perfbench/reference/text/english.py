"""English g2p: text -> IPA.

Behavioral reference: reference text/english.py (keithito-style
cleaning, eng_to_ipa conversion, CMU/ARPA fallback for OOV words, dark-l
marking, IPA->IPA2 rewrites).

Backends: `eng_to_ipa` (+ `g2p_en` for OOV) when installed — the reference's
own libraries. Otherwise a dependency-free fallback: a built-in lexicon of
frequent words + rule-based letter-to-sound. The fallback trades accuracy
for availability; its output stays inside the model's symbol inventory.
"""

from __future__ import annotations

import re
import unicodedata

from perfbench.reference.text.numbers import normalize_numbers_en

_abbreviations = [
    (re.compile(r"\b%s\." % x[0], re.IGNORECASE), x[1])
    for x in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"),
        ("gen", "general"), ("drs", "doctors"), ("rev", "reverend"),
        ("lt", "lieutenant"), ("hon", "honorable"), ("sgt", "sergeant"),
        ("capt", "captain"), ("esq", "esquire"), ("ltd", "limited"),
        ("col", "colonel"), ("ft", "fort"),
    ]
]

_ipa_to_ipa2 = [(re.compile(p), r) for p, r in [("r", "ɹ"), ("ʤ", "dʒ"), ("ʧ", "tʃ")]]

# ARPA -> IPA (reference english.py:90-93)
ARPA_TO_IPA = {
    "a": "ə", "ey": "eɪ", "aa": "ɑ", "ae": "æ", "ah": "ə", "ao": "ɔ",
    "aw": "aʊ", "ay": "aɪ", "ch": "ʧ", "dh": "ð", "eh": "ɛ", "er": "ər",
    "hh": "h", "ih": "ɪ", "jh": "ʤ", "ng": "ŋ", "ow": "oʊ", "oy": "ɔɪ",
    "sh": "ʃ", "th": "θ", "uh": "ʊ", "uw": "u", "zh": "ʒ", "iy": "i",
    "y": "j",
}

# built-in lexicon for the dependency-free fallback: the vendored
# CMU-derived frequent-word dictionary (text/en_dict.py, ~5,300 base forms
# with stress marks) layered over the original small seed list below; the
# affix layer in _word_to_ipa_fallback derives regular inflections, so the
# effective form coverage is several times larger.
_SEED_LEXICON = {
    "a": "ə", "an": "æn", "the": "ðə", "of": "əv", "to": "tu", "and": "ænd",
    "in": "ɪn", "is": "ɪz", "it": "ɪt", "you": "ju", "that": "ðæt",
    "he": "hi", "she": "ʃi", "was": "wəz", "for": "fɔɹ", "are": "ɑɹ",
    "with": "wɪð", "as": "æz", "his": "hɪz", "her": "həɹ", "they": "ðeɪ",
    "i": "aɪ", "at": "æt", "be": "bi", "this": "ðɪs", "have": "hæv",
    "from": "fɹəm", "or": "ɔɹ", "one": "wən", "had": "hæd", "by": "baɪ",
    "word": "wəɹd", "but": "bət", "not": "nɑt", "what": "wət",
    "all": "ɔɫ", "were": "wəɹ", "we": "wi", "when": "wɛn", "your": "jɔɹ",
    "can": "kæn", "said": "sɛd", "there": "ðɛɹ", "use": "juz",
    "each": "iʧ", "which": "wɪʧ", "do": "du", "how": "haʊ",
    "their": "ðɛɹ", "if": "ɪf", "will": "wɪɫ", "up": "əp",
    "other": "əðəɹ", "about": "əbaʊt", "out": "aʊt", "many": "mɛni",
    "then": "ðɛn", "them": "ðɛm", "these": "ðiz", "so": "soʊ",
    "some": "səm", "would": "wʊd", "make": "meɪk", "like": "laɪk",
    "him": "hɪm", "into": "ɪntu", "time": "taɪm", "has": "hæz",
    "look": "lʊk", "two": "tu", "more": "mɔɹ", "write": "ɹaɪt",
    "go": "goʊ", "see": "si", "no": "noʊ", "way": "weɪ",
    "could": "kʊd", "my": "maɪ", "than": "ðæn", "first": "fəɹst",
    "been": "bɪn", "who": "hu", "its": "ɪts", "now": "naʊ",
    "people": "pipəɫ", "over": "oʊvəɹ", "did": "dɪd", "down": "daʊn",
    "only": "oʊnli", "world": "wəɹɫd", "hello": "hɛloʊ", "speech": "spiʧ",
    "voice": "vɔɪs", "synthesis": "sɪnθəsɪs", "language": "læŋgwəʤ",
    "model": "mɑdəɫ", "test": "tɛst", "good": "gʊd", "morning": "mɔɹnɪŋ",
    "says": "sɛz", "very": "vɛɹi", "here": "hiɹ", "our": "aʊəɹ",
    "say": "seɪ", "where": "wɛɹ", "after": "æftəɹ", "little": "lɪtəɫ",
    "know": "noʊ", "should": "ʃʊd", "because": "bɪkɔz", "through": "θɹu",
    "years": "jɪɹz", "day": "deɪ", "does": "dəz", "come": "kəm",
    "new": "nu", "sound": "saʊnd", "work": "wəɹk", "three": "θɹi",
    "word's": "wəɹdz", "give": "gɪv",
}

from perfbench.reference.text.en_dict import WORDS as _EN_DICT  # noqa: E402

_LEXICON = dict(_SEED_LEXICON)
_LEXICON.update(_EN_DICT)  # the vendored dictionary wins (adds stress marks)

_SIBILANT_FINAL = tuple("szʃʒʧʤ")
_VOICELESS_FINAL = tuple("ptkfθ")

# ordered rule-based letter-to-sound rules (fallback path only)
_LTS_RULES = [
    ("ation", "eɪʃən"),
    ("tion", "ʃən"), ("sion", "ʒən"), ("ture", "ʧər"), ("ought", "ɔt"),
    ("augh", "æf"), ("ough", "ʌf"), ("eigh", "eɪ"), ("igh", "aɪ"),
    ("tch", "ʧ"), ("dge", "ʤ"), ("nge", "nʤ"), ("ck", "k"),
    ("wh", "w"), ("wr", "r"),
    ("kn", "n"), ("qu", "kw"), ("ph", "f"), ("gh", "g"), ("sh", "ʃ"),
    ("ch", "ʧ"), ("th", "θ"), ("ng", "ŋ"), ("oo", "u"), ("ee", "i"),
    ("ea", "i"), ("ou", "aʊ"), ("ow", "oʊ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("au", "ɔ"), ("aw", "ɔ"), ("oa", "oʊ"),
    ("ie", "i"), ("ue", "u"), ("ew", "u"), ("eu", "u"),
    # r-colored vowels carry PLAIN r here: LTS output is at the same level
    # as en_dict entries (the global _ipa_to_ipa2 rewrite turns r into ɹ
    # downstream for both paths), so the two are directly comparable — the
    # golden fixture tests/fixtures/en_lts_gold.tsv depends on this
    ("ar", "ɑr"), ("er", "ər"),
    ("ir", "ər"), ("or", "ɔr"), ("ur", "ər"),
    ("a", "æ"), ("b", "b"), ("c", "k"), ("d", "d"), ("e", "ɛ"),
    ("f", "f"), ("g", "g"), ("h", "h"), ("i", "ɪ"), ("j", "ʤ"),
    ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("o", "ɑ"),
    ("p", "p"), ("q", "k"), ("r", "r"), ("s", "s"), ("t", "t"),
    ("u", "ə"), ("v", "v"), ("w", "w"), ("x", "ks"), ("y", "i"),
    ("z", "z"), ("'", ""),
    # magic-e long vowels (uppercased by _letter_to_sound's silent-e strip)
    ("A", "eɪ"), ("E", "i"), ("I", "aɪ"), ("O", "oʊ"), ("U", "ju"),
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = regex.sub(replacement, text)
    return text


def collapse_whitespace(text: str) -> str:
    return re.sub(r"\s+", " ", text)


def mark_dark_l(text: str) -> str:
    """l before non-vowel/word-end -> dark l (reference english.py:65-66)."""
    return re.sub(r"l([^aeiouæɑɔəɛɪʊ ]*(?: |$))", lambda m: "ɫ" + m.group(1), text)


def _strip_accents(text: str) -> str:
    """unidecode-lite: NFKD + drop combining marks."""
    return "".join(
        c for c in unicodedata.normalize("NFKD", text)
        if not unicodedata.combining(c) and ord(c) < 128
    )


def _plural_suffix(base_ipa: str) -> str:
    """-s allomorph: /ɪz/ after sibilants, /s/ after voiceless, else /z/."""
    if base_ipa.endswith(_SIBILANT_FINAL):
        return "ɪz"
    if base_ipa.endswith(_VOICELESS_FINAL):
        return "s"
    return "z"


def _past_suffix(base_ipa: str) -> str:
    """-ed allomorph: /ɪd/ after t,d; /t/ after voiceless; else /d/."""
    if base_ipa.endswith(("t", "d")):
        return "ɪd"
    if base_ipa.endswith(_VOICELESS_FINAL) or base_ipa.endswith(
            ("s", "ʃ", "ʧ")):
        return "t"
    return "d"


def _derived(base_ipa: str, suffix: str) -> str:
    """Attach a derivational suffix, adding word-initial stress when the
    suffix makes a monosyllabic base polysyllabic (eng_to_ipa marks stress
    in polysyllables only: play -> ˈpleɪɪŋ, walked stays wɔkt)."""
    if base_ipa.endswith("l") and suffix == "li":
        out = base_ipa + "i"  # careful + ly -> ˈkɛrfəli, not -lli
    else:
        out = base_ipa + suffix
    if "ˈ" not in out and any(v in suffix for v in "ɪəaeiouæɛʊɔ"):
        out = "ˈ" + out
    return out


def _lexicon_base(stem: str) -> str | None:
    """Look up a stem allowing silent-e restore, consonant undoubling
    (stopp -> stop), and y->i spelling (happi -> happy)."""
    if stem in _LEXICON:
        return _LEXICON[stem]
    if stem + "e" in _LEXICON:  # making -> make
        return _LEXICON[stem + "e"]
    if (len(stem) >= 3 and stem[-1] == stem[-2]
            and stem[:-1] in _LEXICON):  # stopp -> stop
        return _LEXICON[stem[:-1]]
    if stem.endswith("i") and stem[:-1] + "y" in _LEXICON:  # happi -> happy
        return _LEXICON[stem[:-1] + "y"]
    return None


def _word_to_ipa_fallback(word: str) -> str:
    ipa = _lexicon_lookup(word)
    if ipa is not None:
        return ipa
    # OOV inflection: peel possessive / past endings so the suffix reads
    # with the right allomorph instead of as spelled letters
    if len(word) > 3 and (word.endswith("'s") or word.endswith("s'")):
        base = _word_to_ipa_fallback(word[:-2])
        return base + _plural_suffix(base)
    if len(word) >= 6 and word.endswith("ies"):
        base = _word_to_ipa_fallback(word[:-3] + "y")  # modalities
        if base.endswith("i"):
            return base + "z"
    tpl = _template_lts(word)
    if tpl is not None:
        return tpl
    if (len(word) >= 5 and word.endswith("ed")
            and word[-3] not in "aeiouy"):
        stem = word[:-2]
        if len(stem) >= 3 and stem[-1] == stem[-2]:  # planned -> plan
            stem = stem[:-1]
        base = _letter_to_sound(stem + "e")  # magic-e fires where due
        return base + _past_suffix(base)
    if (len(word) >= 6 and word.endswith("ing")
            and word[-4] not in "aeiou"):
        stem = word[:-3]
        if len(stem) >= 3 and stem[-1] == stem[-2]:
            stem = stem[:-1]
        base = _letter_to_sound(stem + "e")  # traipsing -> traipse
        return _derived(base, "ɪŋ")
    return _letter_to_sound(word.replace("'", ""))


def _lexicon_lookup(word: str) -> str | None:
    """Resolve via the vendored lexicon or its affix layer; None on miss."""
    if word in _LEXICON:
        return _LEXICON[word]
    # ---- affix layer: derive regular inflections from lexicon bases ----
    if word.endswith("'s") or word.endswith("s'"):
        base = _lexicon_base(word[:-2])
        if base is None and len(word) >= 7:
            # possessive of a form the affix layer itself derives
            # (affirmer's, contributor's) — one recursive level
            base = _lexicon_lookup(word[:-2])
        if base is not None:
            return _derived(base, _plural_suffix(base))
    if word.endswith("ies") and word[:-3] + "y" in _LEXICON:
        # cities -> city (+z after the -i), flies -> fly (+z after -aɪ)
        return _LEXICON[word[:-3] + "y"] + "z"
    if word.endswith("es"):
        base = _lexicon_base(word[:-2])
        if base is not None:
            return _derived(base, _plural_suffix(base))
    if word.endswith("s") and not word.endswith("ss"):
        base = _lexicon_base(word[:-1])
        if base is None and len(word) >= 6:
            # plural of a word the affix layer itself derives
            # (holders, contributors, misreadings) — one recursive level
            base = _lexicon_lookup(word[:-1])
        if base is not None:
            return _derived(base, _plural_suffix(base))
    if word.endswith("ied") and word[:-3] + "y" in _LEXICON:
        base = _LEXICON[word[:-3] + "y"]  # carried -> carry
        return base + "d"
    if word.endswith("ed"):
        # prefer the e-final base (hoped -> hope, not the shorter word hop)
        base = _lexicon_base(word[:-1]) or _lexicon_base(word[:-2])
        if base is not None:
            return _derived(base, _past_suffix(base))
    if word.endswith("ing"):
        base = _lexicon_base(word[:-3])
        if base is not None:
            return _derived(base, "ɪŋ")
    if word.endswith("est"):
        base = _lexicon_base(word[:-3])
        if base is not None:
            return _derived(base, "əst")
    if word.endswith("er"):
        # prefer the e-final base (diner -> dine, not the shorter word din)
        base = _lexicon_base(word[:-1]) or _lexicon_base(word[:-2])
        if base is not None:
            return _derived(base, "ər")
    if word.endswith("or") and len(word) >= 6:
        # latinate agent nouns: contributor -> contribute, director -> direct
        base = _lexicon_base(word[:-2])
        if base is not None:
            return _derived(base, "ər")
    if word.endswith("ly"):
        base = _lexicon_base(word[:-2])
        if base is not None:
            return _derived(base, "li")
    for suf, ipa in (("ness", "nəs"), ("ment", "mənt"), ("ful", "fəl"),
                     ("less", "ləs"), ("ship", "ˌʃɪp"), ("hood", "ˌhʊd"),
                     ("al", "əl"), ("ous", "əs"), ("ish", "ɪʃ"),
                     ("able", "əbəl"), ("ible", "əbəl"),
                     ("ance", "əns"), ("ence", "əns")):
        if word.endswith(suf) and len(word) - len(suf) >= 3:
            base = _lexicon_base(word[: -len(suf)])
            if base is not None:
                return _derived(base, ipa)
    if word.endswith("y") and len(word) >= 4:
        # -y adjectivizer: rain -> rainy, dust -> dusty, crust -> crusty
        base = _lexicon_base(word[:-1])
        if base is not None and not base.endswith(tuple("iəaeɪu")):
            return _derived(base, "i")
    for pre, ipa in (("un", "ən"), ("re", "ri"), ("dis", "dɪs"),
                     ("pre", "pri"), ("non", "nɑn"), ("over", "ˌoʊvər"),
                     ("out", "ˌaʊt"), ("mis", "mɪs")):
        if word.startswith(pre) and len(word) - len(pre) >= 3:
            rest = word[len(pre):]
            hit = _LEXICON.get(rest)
            if hit is None and len(rest) >= 5:
                # prefix on a derived form (unsupported, disclaimer) —
                # one recursive level through the suffix rules
                hit = _lexicon_lookup(rest)
            if hit is not None:
                if pre == "re" and rest[0] in "aeiou" and hit[0] not in "ˈˌ":
                    # re- before a vowel-initial base carries a secondary
                    # (ˌriəˈʃʊrəns)
                    return "ˌ" + ipa + hit
                return ipa + hit
    # closed compound of two lexicon words (seashell, sunlight, raincoat):
    # primary stress on the first element, secondary on the second —
    # the regular English compound-stress pattern
    if len(word) >= 7:
        for cut in range(3, len(word) - 2):
            a, b = word[:cut], word[cut:]
            if a in _LEXICON and b in _LEXICON:
                ipa_b_marked = _LEXICON[b]
                if a in ("counter", "under", "over", "inter", "semi",
                         "multi") and "ˈ" in ipa_b_marked:
                    # combining prefix + self-stressed polysyllable is NOT
                    # a noun compound (counterintuitive keeps the base's
                    # primary) — the template layer handles it
                    continue
                ipa_a = _LEXICON[a].replace("ˈ", "").replace("ˌ", "")
                ipa_b = ipa_b_marked.replace("ˈ", "").replace("ˌ", "")
                return "ˈ" + ipa_a + "ˌ" + ipa_b
    return None


# nucleus tokens for syllabification (diphthongs before monophthongs)
_NUCLEI = re.compile(r"eɪ|aɪ|oʊ|aʊ|ɔɪ|[iuɪʊɛæɑɔəɜ]")

# legal English syllable onsets (clusters; any single consonant is legal)
_LEGAL_ONSETS = frozenset(
    "pl pr bl br tr dr kr kl gr gl fr fl fj θr θw sl sm sn sp st sk sw tw "
    "dw kw gw ʃr vj pj bj tj dj kj mj nj lj hj sf "
    "spr str skr spl skw spj stj skj".split()
)


def _add_default_stress(ipa: str) -> str:
    """Give a stressless LTS output a primary stress mark (eng_to_ipa marks
    stress in every polysyllable; a stressless polysyllable reads flat and
    is outside the reference distribution). Suffix-aware placement:
    -tion/-sion and -ic stress the preceding syllable, -ity/-ology/-ography
    the antepenult; everything else defaults to initial stress."""
    if "ˈ" in ipa or "ˌ" in ipa:
        return ipa
    nuclei = list(_NUCLEI.finditer(ipa))
    if len(nuclei) < 2:
        return ipa
    k = 0
    if re.search(r"(ʃ|ʒ)ən$", ipa) or ipa.endswith(("ɪk", "əns", "ɪʃəs")):
        k = len(nuclei) - 2
    elif re.search(r"([ɪə]ti|ədʒi|əfi|əmi|əni)$", ipa):
        k = max(len(nuclei) - 3, 0)
    start = nuclei[k].start()
    if k == 0:
        return "ˈ" + ipa
    # onset: take the longest phonotactically legal cluster before the
    # stressed nucleus (kwɪksɑtɪk -> kwɪk.ˈsɑ, not kwɪ.ˈksɑ)
    prev_end = nuclei[k - 1].end()
    cluster = ipa[prev_end:start]
    onset = len(cluster)
    while onset > 1 and cluster[-onset:] not in _LEGAL_ONSETS:
        onset -= 1
    return ipa[: start - onset] + "ˈ" + ipa[start - onset:]


# ---------------------------------------------------------------------------
# Template letter-to-sound (VERDICT r4 item #4b): suffix-family stress
# templates with vowel reduction for the productive latinate / name /
# compound vocabulary that dominates real OOV words. Tried before the
# generic rule LTS; returns None when no template applies. Accuracy is
# measured against the hand-transcribed golden fixture
# tests/fixtures/en_lts_gold.tsv by tools/en_lts_accuracy.py.
# Reference behavior: g2p_en's trained model fills this role for the
# reference (reference text/english.py:100-122); this is the
# dependency-free rule equivalent.
# ---------------------------------------------------------------------------

# neoclassical combining forms / transparent prefixes: (spelling, ipa with
# its own secondary stress embedded, final-oʊ-reducible-before-primary)
_COMBINING = [
    ("electro", "ɪˌlɛktroʊ", False), ("thermo", "ˌθərmoʊ", True),
    ("stereo", "ˌstɛrioʊ", False), ("hydro", "ˌhaɪdroʊ", True),
    ("micro", "ˌmaɪkroʊ", True), ("macro", "ˌmækroʊ", True),
    ("psycho", "ˌsaɪkoʊ", True), ("econo", "ɪˌkɑnoʊ", True),
    ("quadra", "ˌkwɑdrə", False), ("mega", "ˌmɛgə", False),
    ("tele", "ˌtɛlə", False), ("bio", "ˌbaɪoʊ", False),
    ("geo", "ˌʤioʊ", False), ("circum", "ˌsərkəm", False),
    ("counter", "ˌkaʊntər", False), ("under", "ˌəndər", False),
    ("inter", "ˌɪntər", False), ("over", "ˌoʊvər", False),
    ("trans", "ˌtrænz", False), ("mid", "ˌmɪd", False),
    ("semi", "ˌsɛmi", False), ("multi", "ˌməlti", False),
    ("tri", "traɪ", False),
]

# lexicalized reduced prefixes for unstressed word-initial position
_PRE_REDUCED = [
    ("con", "kən"), ("com", "kəm"), ("per", "pər"), ("pro", "prə"),
    ("sub", "səb"), ("sur", "sər"), ("sus", "səs"), ("dis", "dɪs"),
    ("ex", "ɪks"), ("de", "di"), ("re", "rɪ"), ("pre", "pri"),
    ("in", "ɪn"), ("im", "ɪm"), ("en", "ɛn"), ("em", "ɛm"),
]

# tail-stressed suffixes: primary lives inside the tail IPA; the stem is
# transcribed reduced with a secondary on its first vowel (>=2 stem vowels)
_TAIL_STRESSED = [
    ("ographer", "ˈɑgrəfər"), ("ographic", "əˈgræfɪk"),
    ("ography", "ˈɑgrəfi"), ("ocracy", "ˈɑkrəsi"), ("ocratic", "əˈkrætɪk"),
    ("ology", "ˈɑləʤi"), ("ologist", "ˈɑləʤɪst"), ("ometry", "ˈɑmətri"),
    ("ometer", "ˈɑmətər"), ("escent", "ˈɛsənt"), ("escence", "ˈɛsəns"),
    ("iferous", "ˈɪfərəs"), ("ectomy", "ˈɛktəmi"), ("osis", "ˈoʊsəs"),
    ("itis", "ˈaɪtəs"), ("arium", "ˈɛriəm"), ("orium", "ˈɔriəm"),
    ("arian", "ˈɛriən"), ("onian", "ˈoʊniən"), ("esque", "ˈɛsk"),
    ("ential", "ˈɛnʃəl"), ("ention", "ˈɛnʃən"), ("ician", "ˈɪʃən"),
    ("isian", "ˈɪʒən"), ("metric", "ˈmɛtrɪk"), ("phonic", "ˈfɑnɪk"),
    ("tronic", "ˈtrɑnɪk"), ("genic", "ˈʤɛnɪk"), ("uity", "ˈuəti"),
    ("ivity", "ˈɪvəti"), ("ality", "ˈæləti"), ("ese", "ˈiz"),
    ("etical", "ˈɛtɪkəl"), ("itical", "ˈɪtɪkəl"), ("atical", "ˈætɪkəl"),
    ("iloquent", "ˈɪləkwənt"), ("ocution", "oʊˈkjuʃən"),
    ("etrical", "ˈɛtrɪkəl"), ("ational", "ˈeɪʃənəl"),
    # last resort for -ation words the -ate chain can't derive
    ("ation", "ˈeɪʃən"),
]

# stem-stressed suffixes: (spelling, tail ipa with optional secondary,
# primary position = n vowels BEFORE the last stem vowel)
_STEM_STRESSED = [
    ("ating", "ˌeɪtɪŋ", 1), ("ated", "ˌeɪtɪd", 1), ("ator", "ˌeɪtər", 1),
    ("ate", "ˌeɪt", 1), ("izing", "ˌaɪzɪŋ", 1), ("ized", "ˌaɪzd", 1),
    ("izer", "ˌaɪzər", 1), ("ize", "ˌaɪz", 1), ("itude", "əˌtud", 0),
    ("ite", "ˌaɪt", 1), ("ile", "ˌaɪl", 0), ("ible", "əbəl", 0),
    ("able", "əbəl", 0), ("ment", "mənt", "verb"),
    ("ington", "ɪŋtən", None), ("ton", "tən", None),
    ("man", "mən", None), ("sley", "zli", None), ("ley", "li", None),
]

# compound second elements: value (ipa, pattern). pattern "first" = primary
# on the first element (regular noun compounds); "second" = primary on the
# tail (participial compounds: shortchanged, freewheeling)
_COMPOUND_TAILS = {
    "dale": ("ˌdeɪl", "first"), "field": ("ˌfild", "first"),
    "stone": ("ˌstoʊn", "first"), "wood": ("ˌwʊd", "first"),
    "berg": ("ˌbərg", "first"), "ville": ("ˌvɪl", "first"),
    "smith": ("ˌsmɪθ", "first"), "smithing": ("ˌsmɪθɪŋ", "first"),
    "smiths": ("ˌsmɪθs", "first"), "wright": ("ˌraɪt", "first"),
    "wrights": ("ˌraɪts", "first"), "stick": ("ˌstɪk", "first"),
    "sticks": ("ˌstɪks", "first"), "bone": ("ˌboʊn", "first"),
    "load": ("ˌloʊd", "first"), "proofing": ("ˌprufɪŋ", "first"),
    "working": ("ˌwərkɪŋ", "first"), "lighting": ("ˌlaɪtɪŋ", "first"),
    "lighter": ("ˌlaɪtər", "first"), "lighters": ("ˌlaɪtərz", "first"),
    "binding": ("ˌbaɪndɪŋ", "first"), "blowing": ("ˌbloʊɪŋ", "first"),
    "surfing": ("ˌsərfɪŋ", "first"), "sailing": ("ˌseɪlɪŋ", "first"),
    "seiling": ("ˌseɪlɪŋ", "first"),
    "making": ("ˌmeɪkɪŋ", "first"), "carving": ("ˌkɑrvɪŋ", "first"),
    "hole": ("ˌhoʊl", "first"), "holed": ("ˌhoʊld", "first"),
    "holes": ("ˌhoʊlz", "first"), "side": ("ˌsaɪd", "first"),
    "sided": ("ˌsaɪdɪd", "first"), "changed": ("ʧeɪnʤd", "second"),
    "wheeling": ("wilɪŋ", "second"),
}

_V_LETTERS = "aeiouy"
# single-vowel-letter qualities
_V_CHECKED = {"a": "æ", "e": "ɛ", "i": "ɪ", "o": "ɑ", "u": "ə", "y": "ɪ"}
_V_OPEN = {"a": "eɪ", "e": "i", "i": "aɪ", "o": "oʊ", "u": "ju", "y": "aɪ"}
_V_DIGRAPH = {
    "oo": "u", "ee": "i", "ea": "i", "ai": "eɪ", "ay": "eɪ", "oa": "oʊ",
    "ou": "aʊ", "ow": "oʊ", "oi": "ɔɪ", "oy": "ɔɪ", "au": "ɔ", "aw": "ɔ",
    "eu": "u", "ew": "u", "ie": "i", "ei": "eɪ", "ue": "u",
}
_CONS_MAP = [
    ("tch", "ʧ"), ("dge", "ʤ"), ("ck", "k"), ("wh", "w"), ("wr", "r"),
    ("kn", "n"), ("ph", "f"), ("sh", "ʃ"), ("ch", "ʧ"), ("th", "θ"),
    ("gh", "g"), ("qu", "kw"), ("x", "ks"),
]


def _split_units(s: str) -> list[str]:
    """Spelling -> alternating consonant-run / vowel-group units ('qu'
    counts as a consonant so the u doesn't found a syllable)."""
    s = s.replace("qu", "qw")
    return re.findall(r"[aeiouy]+|[^aeiouy]+", s)


def _cons_ipa(c: str, next_letter: str) -> str:
    """Consonant run -> IPA, with soft c/g decided by the next letter."""
    out = ""
    i = 0
    c = re.sub(r"([bcdfgklmnprstvz])\1", r"\1", c)
    while i < len(c):
        if c.startswith("ch", i) and i + 2 < len(c):
            out += "k"  # greek ch before a consonant (techn-, chrono-)
            i += 2
            continue
        for pat, rep in _CONS_MAP:
            if c.startswith(pat, i):
                out += rep
                i += len(pat)
                break
        else:
            ch = c[i]
            nxt = c[i + 1] if i + 1 < len(c) else next_letter
            if ch == "c":
                out += "s" if nxt in "eiy" else "k"
            elif ch == "g":
                out += "ʤ" if nxt in "ey" else "g"
            elif ch == "n" and nxt == "g":
                out += "ŋ"
                i += 2
                # ng before a vowel keeps the g (angul -> æŋg)
                if i >= len(c) and next_letter in _V_LETTERS:
                    out += "g"
                elif i < len(c):
                    out += "g" if c[i] in _V_LETTERS or c[i] in "rl" else ""
                continue
            elif ch == "q":
                out += "k"
            elif ch == "j":
                out += "ʤ"
            else:
                out += ch
            i += 1
    return out


def _vowel_ipa(vg: str, stress: int, open_syl: bool, before_r: bool,
               geminate_r: bool, prev_cons: str, next_is_vowel: bool,
               next_cons: str = "", lax: bool = True,
               is_first: bool = False) -> str:
    """One vowel group -> IPA. stress: 2 primary, 1 secondary, 0 none,
    3 = lone-vowel stem (full quality, caller omits the mark)."""
    if before_r and len(vg) == 1:
        # geminate_r carries the caller's full intervocalic-r determination
        # (rr, or a lone r directly followed by a vowel)
        intervocalic = geminate_r
        if stress == 3:
            if intervocalic:
                return "ər"  # the r re-onsets the tail (pəˈrɪʒən, fəˈrɑ)
            return {"a": "ɑr", "e": "ər", "i": "ər", "o": "ɔr",
                    "u": "ər", "y": "ər"}[vg]
        if stress >= 1:
            # stressed r-colored keeps quality (ˌstɛr, ˈɑrlɪŋtən, ˌkɔri)
            return {
                "a": "ɛr" if intervocalic else "ɑr",
                "e": "ɛr" if intervocalic else "ər",
                "i": "ɪr" if intervocalic else "ər",
                "o": "ɔr", "u": "ər", "y": "ər",
            }[vg]
        return "ər"  # unstressed r-colored reduces (pərˈsɛn, ˌdərmə)
    if len(vg) >= 2 and vg[:2] in _V_DIGRAPH:
        return _V_DIGRAPH[vg[:2]] + ("" if len(vg) == 2 else _V_CHECKED.get(vg[2], ""))
    v = vg[0]
    if v == "a" and prev_cons.endswith("w"):
        return "ɑ"  # wa- (ˌwɑʃɪŋ, ˌkwɑdrə)
    if stress == 3:
        # lone-vowel stem before a stressed tail: full quality, no mark
        # (tɛkˈnɑkrəsi, pluˈtɑkrəsi, faɪˈbroʊsəs, moʊˈdæləti, stəˈnɑ)
        if open_syl:
            if next_is_vowel and v in "ie":
                return "i"  # hiatus (ˌθiəˈkrætɪk)
            return {
                "a": "æ", "e": "ə", "o": "oʊ",
                "i": "aɪ" if len(next_cons) > 1 else "ɪ",
                "y": "aɪ" if len(next_cons) > 1 else "ɪ",
                "u": "u" if len(prev_cons) > 1 else "ju",
            }[v]
        return _V_CHECKED[v]
    if stress == 2:
        if not lax and open_syl:
            # non-laxing suffixes (-ite, -ile) keep the reading vowel
            # (ˈdoʊləˌmaɪt, ˈhiməˌtaɪt)
            return {"a": "æ", "e": "i", "i": "aɪ", "o": "oʊ", "u": "ju",
                    "y": "aɪ"}[v]
        if v == "u" and open_syl:
            return "u" if prev_cons.endswith(("l", "r")) else "ju"
        # latinate primary: trisyllabic-laxing territory -> checked quality
        return _V_CHECKED[v]
    if stress == 1:
        # secondary syllables keep full-ish quality; open a/e stay lax
        # (ˌʤævə, ˌnɛpə) except e after a cluster onset (ˌkri'mə)
        if open_syl:
            return {"a": "æ",
                    "e": "i" if len(prev_cons) > 1 else "ɛ",
                    "i": "ɪ", "o": "oʊ", "u": "u", "y": "ɪ"}[v]
        return _V_CHECKED[v]
    # unstressed: reduce
    if v in "iy" and next_cons.startswith("ng"):
        return "ɪ"  # -ing- inside a stem (ˈwɑʃɪŋtən)
    if v in "iy" and not open_syl and not next_is_vowel:
        return "ɪ"  # closed unstressed i (ˈblændɪʃ, dɪs-)
    if v in "iy" or (v == "e" and next_is_vowel):
        return "i" if next_is_vowel else "ə"
    if v == "u":
        if prev_cons.endswith("t"):
            return "ʧə"  # palatalization; caller strips the t/d letter
        if prev_cons.endswith("d"):
            return "ʤə"
        if open_syl and not is_first:
            if len(prev_cons) > 1 and prev_cons[-1] in "rl":
                return "u"  # cluster onset keeps u (gru, plu)
            if prev_cons:
                return "jə"  # medial -Cul- territory (kjə, gjə, njə)
        return "ə"
    if v == "o" and open_syl and not prev_cons:
        return "oʊ"  # hiatus / word-initial open o keeps quality (ˌstɛrioʊ)
    return "ə"


_ONSETS_FOR_MARK = _LEGAL_ONSETS | frozenset(
    "b d f g h k l m n p r s t v w z ʃ ʧ ʤ θ ð ʒ j".split()
)


def _attach_marks(ipa: str) -> str:
    """Re-seat each stress mark at its syllable boundary: of the full
    intervocalic consonant cluster around the mark, the longest legal onset
    becomes the stressed syllable's onset (ˈmægnətˌaɪt -> ˈmægnəˌtaɪt,
    prɑmptəˈtud stays, ɪgˈzæk stays: gz is not a legal onset)."""
    vowels = "aeiouɑæɛɪʊɔəʊ"
    out = ipa
    for mark in ("ˈ", "ˌ"):
        while True:
            i = out.find(mark)
            pos = -1
            while i != -1:
                # A: consonants immediately before the mark
                j = i
                while j > 0 and out[j - 1] not in vowels and out[j - 1] not in "ˈˌ":
                    j -= 1
                # B: consonants after the mark up to the next vowel
                k = i + 1
                while k < len(out) and out[k] not in vowels and out[k] not in "ˈˌ":
                    k += 1
                cluster = out[j:i] + out[i + 1:k]
                # longest legal suffix of the cluster = stressed onset;
                # must include all of B (the mark never moves right)
                onset = len(cluster)
                min_onset = k - i - 1
                while onset > min_onset and (
                    onset > 0 and cluster[-onset:] not in _ONSETS_FOR_MARK
                ):
                    onset -= 1
                new_pos = k - 1 - onset  # index of mark after removal
                if new_pos != i:
                    pos = i
                    break
                i = out.find(mark, i + 1)
            if pos == -1:
                break
            s = out[:pos] + out[pos + 1:]
            out = s[:new_pos] + mark + s[new_pos:]
    return out


def _tpl_transcribe_stem(stem: str, primary_vowel: int | None,
                         tail_first_letter: str, secondary: bool = True,
                         lax: bool = True) -> str | None:
    """Transcribe a stem spelling with stress-conditioned vowel reduction.

    primary_vowel: index (from 0) of the stem vowel group carrying primary
    stress, or None for a fully-reduced stem. A secondary mark goes on the
    first vowel when it is >=2 groups before the primary (or when the stem
    is fully reduced with >=2 vowel groups and `secondary`).
    """
    units = _split_units(stem)
    if not units:
        return None
    # hiatus splitting: i/u-initial vowel pairs are two syllables, not a
    # digraph (tri.angul, gradu.al) — digraph spellings (ea, ie, ou...)
    # stay fused via _V_DIGRAPH
    split = []
    for u in units:
        if len(u) == 2 and u in ("ia", "io", "iu", "ua", "uo", "eo"):
            split += [u[0], u[1]]
        else:
            split.append(u)
    units = split
    vgroups = [u for u in units if u[0] in _V_LETTERS]
    n_v = len(vgroups)
    if n_v == 0:
        return None
    # unstressed initial reduced prefix (rɪ-, di-, kən-): only when a later
    # vowel carries the primary (fully-reduced stems keep their initial
    # secondary instead: ˌkɑntrəˈvɛnʃən, ˌdərməˈtaɪtəs)
    pre_ipa = ""
    if primary_vowel is not None and primary_vowel != 0 and n_v >= 2:
        for pre, ipa in _PRE_REDUCED:
            if stem.startswith(pre) and any(
                c in _V_LETTERS for c in stem[len(pre):]
            ):
                rest = stem[len(pre):]
                if rest[0] in _V_LETTERS:
                    break  # prefix must consume its whole vowel group
                if pre == "ex":
                    # the spelled s carries the /s/ (exsanguinate -> ɪk-s);
                    # before c the c itself reads /k/ so keep ɪks (ex-cori)
                    ipa = "ɪk" if rest[0] == "s" else "ɪks"
                stem = rest
                pre_ipa = ipa
                units = _split_units(stem)
                vgroups = [u for u in units if u[0] in _V_LETTERS]
                n_v = len(vgroups)
                primary_vowel -= 1
                if n_v == 0 or primary_vowel < 0:
                    return None
                break

    out = []
    kinds = []  # parallel: "c" consonant run, "v" vowel
    vi = 0
    for ui in range(len(units)):
        u = units[ui]
        if not u:  # emptied by r-absorption
            continue
        if u[0] not in _V_LETTERS:
            nxt = units[ui + 1][0] if ui + 1 < len(units) else tail_first_letter
            if ui == len(units) - 1 and u.endswith("ch"):
                u = u[:-2] + "k"  # greek stem-final ch (malach-, monarch-)
            c_ipa = _cons_ipa(u, nxt or "a")
            if out and kinds and kinds[-1] == "c" and c_ipa and \
                    out[-1].endswith(c_ipa[0]):
                c_ipa = c_ipa[1:]  # dedupe at prefix junction (ɪks + s...)
            out.append(c_ipa)
            kinds.append("c")
            continue
        # stress for this vowel group
        if n_v == 1 and primary_vowel is None:
            stress = 3  # lone-vowel stem: full quality, no mark
        elif primary_vowel is not None and vi == primary_vowel:
            stress = 2
        elif vi == 0 and not pre_ipa and (
            (primary_vowel is None and n_v >= 2 and secondary)
            or (primary_vowel is not None and primary_vowel >= 2)
        ):
            stress = 1
        else:
            stress = 0
        # openness: a following single consonant or legal onset cluster
        # leaves the syllable open (fi.brosis, na.vig)
        following = units[ui + 1] if ui + 1 < len(units) else ""
        if following and following[0] in _V_LETTERS:
            following = ""
        fol_dedup = re.sub(r"(.)\1", r"\1", following)
        open_syl = len(fol_dedup) <= 1 or fol_dedup in _LEGAL_ONSETS
        before_r = bool(following) and following[0] == "r"
        geminate_r = following.startswith("rr")
        mark = {3: "", 2: "ˈ", 1: "ˌ", 0: ""}[stress]
        if before_r and len(u) == 1:
            # r-colored vowel; the emitted quality carries the r. The r is
            # intervocalic when nothing but it stands before the next vowel
            nxt_v = (
                (ui + 1 == len(units) - 1 and tail_first_letter in _V_LETTERS)
                or (ui + 2 < len(units) and bool(units[ui + 2])
                    and units[ui + 2][0] in _V_LETTERS)
            )
            intervocalic = geminate_r or (len(following) == 1 and nxt_v)
            out.append(mark + _vowel_ipa(
                u, stress, open_syl, True, intervocalic, "", nxt_v,
            ))
            kinds.append("r")  # the r lives in the vowel; next vowel is
            units[ui + 1] = following[2:] if geminate_r else following[1:]
            vi += 1            # post-consonantal, not hiatus
            continue
        if out and kinds and kinds[-1] == "c":
            prev_cons = out[-1]
        elif kinds and kinds[-1] == "r":
            prev_cons = "r"
        else:
            prev_cons = ""
        prev_cons = prev_cons.lstrip("ˈˌ")
        next_is_vowel = (ui + 1 >= len(units) and tail_first_letter in _V_LETTERS) or (
            ui + 1 < len(units) and bool(units[ui + 1]) and units[ui + 1][0] in _V_LETTERS
        )
        q = _vowel_ipa(u, stress, open_syl, False, False, prev_cons,
                       next_is_vowel, next_cons=following, lax=lax,
                       is_first=vi == 0)
        # palatalized tu/du swallow the preceding consonant's letter
        if q in ("ʧə", "ʤə") and out and out[-1] and out[-1][-1] in "td":
            out[-1] = out[-1][:-1]
        out.append(mark + q)
        kinds.append("v")
        vi += 1
    return pre_ipa + "".join(out)


def _tpl_stem_ipa(stem: str) -> str | None:
    """Stem via lexicon (real stress) or reduced-prefix + lexicon rest."""
    if len(stem) < 4:
        return None
    hit = _LEXICON.get(stem) or _lexicon_base(stem)
    if hit:
        return hit
    for pre, ipa in _PRE_REDUCED:
        if stem.startswith(pre):
            rest = stem[len(pre):]
            rest_hit = _LEXICON.get(rest)
            if rest_hit and sum(
                1 for u in _split_units(rest) if u[0] in _V_LETTERS
            ) >= 2:
                return ipa + rest_hit
    return None


# irregular famous stems the syllable engine cannot derive (kept tiny on
# purpose: broad coverage belongs to the rules, not this table)
_STEM_OVERRIDES = {"ocean": "ˌoʊʃən", "chore": "ˌkɔri", "radi": "ˌreɪdi"}

_CHAIN_TAIL = re.compile(r"ˌ([^ˈˌ]*?)(eɪt|aɪz)$")


def _template_lts(word: str, depth: int = 0) -> str | None:
    """Suffix/prefix-template transcription; None when nothing applies."""
    if depth > 2 or len(word) < 5:
        return None
    # 1. combining prefixes with a resolvable remainder
    for pre, ipa, reducible in _COMBINING:
        if word.startswith(pre) and len(word) - len(pre) >= 3:
            rest = word[len(pre):]
            hit = _lexicon_lookup(rest) or _template_lts(rest, depth + 1)
            if hit is None:
                # bare stress-bearing suffix as the whole remainder
                # (telephonic = tele + phonic)
                for suf, tail in _TAIL_STRESSED:
                    if rest == suf:
                        hit = tail
                        break
            if hit and any(v in hit for v in "ɑæɛɪiʊuɔəoa"):
                if pre in ("semi", "multi") and sum(
                    c in "ɑæɛɪiʊuɔəoa" for c in hit
                ) <= 3:
                    # short rest: compound-noun pattern, primary on the
                    # prefix (ˈsɛmiˌkoʊlən, ˈməltiˌkələrd)
                    return _attach_marks(
                        "ˈ" + ipa.lstrip("ˌ")
                        + "ˌ" + hit.replace("ˈ", "").replace("ˌ", "")
                    )
                if "ˈ" not in hit:
                    hit = "ˈ" + hit
                p = ipa
                if reducible and p.endswith("oʊ") and hit.startswith("ˈ"):
                    p = p[:-2] + "ə"
                return p + hit
    # 2. -ization / -ation via the derivational chain (-ize / -ate base):
    # demote the base's primary, the old ˌeɪt/ˌaɪz syllable reduces, the
    # suffix takes the primary (həˈmɑʤəˌnaɪz -> həˌmɑʤənəˈzeɪʃən)
    for suf, base_suf, repl in (
        ("izations", "ize", "əˈzeɪʃənz"), ("ization", "ize", "əˈzeɪʃən"),
        ("ations", "ate", "ˈeɪʃənz"), ("ation", "ate", "ˈeɪʃən"),
    ):
        if word.endswith(suf) and len(word) - len(suf) >= 3:
            if word[: -len(suf)] in _LEXICON:
                # a bare lexicon verb + -ation is stem+ˈeɪʃən directly
                # (protestation), not the -ate derivational pattern
                break
            base = _template_lts(word[: -len(suf)] + base_suf, depth + 1)
            m = _CHAIN_TAIL.search(base) if base else None
            if m:
                core = base[: m.start()].replace("ˈ", "ˌ", 1)
                return _attach_marks(core + m.group(1) + repl)
    # 3. tail-stressed suffixes: reduced stem + secondary on its first vowel
    for suf, tail in _TAIL_STRESSED:
        if word.endswith(suf) and len(word) - len(suf) >= 2:
            stem = word[: -len(suf)]
            if not any(c in _V_LETTERS for c in stem):
                continue
            stem_ipa = _STEM_OVERRIDES.get(stem) or _tpl_transcribe_stem(
                stem, None, suf[0]
            )
            if stem_ipa is None:
                continue
            if ("ˈ" not in stem_ipa and "ˌ" not in stem_ipa
                    and not tail.startswith("ˈ")):
                # lone-vowel stem + pretonic tail syllable: the rhythm rule
                # puts a secondary on the stem (ˌmɑnəˈkrætɪk, ˌkrɪptəˈgræfɪk)
                stem_ipa = "ˌ" + stem_ipa
            return _attach_marks(stem_ipa + tail)
    # 4. stem-stressed suffixes
    for suf, tail, n in _STEM_STRESSED:
        if word.endswith(suf) and len(word) - len(suf) >= 3:
            stem = word[: -len(suf)]
            vcount = sum(1 for u in _split_units(stem) if u[0] in _V_LETTERS)
            if vcount == 0:
                continue
            lax = suf[:3] not in ("ite", "ile")  # -ite/-ile keep long vowels
            if n == "verb":
                # stress-neutral suffix on a verb base: primary on the
                # first post-prefix vowel (dɪsˈbərsmənt, rɪˈplɛnɪʃmənt)
                stem = re.sub(r"([bcdfgklmnprstvz])e$", r"\1", stem)
                pre_ipa = ""
                for pre, p_ipa in _PRE_REDUCED:
                    if stem.startswith(pre):
                        rest = stem[len(pre):]
                        if rest and rest[0] not in _V_LETTERS and any(
                            c in _V_LETTERS for c in rest
                        ):
                            stem, pre_ipa = rest, p_ipa
                            break
                body = _tpl_transcribe_stem(stem, 0, suf[0], lax=lax)
                stem_ipa = pre_ipa + body if body else None
            else:
                stem_ipa = _tpl_stem_ipa(stem) if n is not None else None
                if stem_ipa is not None and suf[0] in "ai":
                    # -ulate/-ulator reduction of a lexicon stem's final u
                    # (granule + -ated -> grænjəl, module -> mɑʤəl)
                    stem_ipa = re.sub(r"([jʤʧ])u(l?)$", r"\1ə\2", stem_ipa)
                if stem_ipa is None:
                    if n is None or vcount - 1 - n < 0:
                        pv = 0  # name suffixes / short stems: initial stress
                    else:
                        pv = vcount - 1 - n
                    stem_ipa = _tpl_transcribe_stem(stem, pv, suf[0], lax=lax)
            if stem_ipa is None:
                continue
            if "ˈ" not in stem_ipa:
                stem_ipa = "ˈ" + stem_ipa
            return _attach_marks(stem_ipa + tail)
    # 5. compound tails
    for tail_sp, (tail_ipa, pattern) in _COMPOUND_TAILS.items():
        if word.endswith(tail_sp) and len(word) - len(tail_sp) >= 3:
            first = word[: -len(tail_sp)]
            hit = _LEXICON.get(first) or _lexicon_base(first)
            if hit is None:
                n_first_v = sum(1 for c in first if c in _V_LETTERS)
                if n_first_v == 1 or (
                    n_first_v == 2 and re.search(r"[^aeiouy]e$", first)
                ):
                    # monosyllables incl. silent-e spellings (lode, wain):
                    # the generic LTS has the magic-e machinery
                    hit = _letter_to_sound(first)
                else:
                    hit = _tpl_transcribe_stem(first, 0, tail_sp[0])
            if hit is None or not any(v in hit for v in "aeiouɑæɛɪʊɔə"):
                continue
            hit = hit.replace("ˌ", "").replace("ˈ", "")
            # marks never migrate across the compound boundary
            # (lamp.lighters, wood.working), so attach within the first
            # element only and concatenate the tail verbatim
            if pattern == "second":
                # participial compounds stress the second element
                # (ˌʃɔrtˈʧeɪnʤd, ˌfriˈwilɪŋ)
                return _attach_marks("ˌ" + hit) + "ˈ" + tail_ipa.lstrip("ˌ")
            return _attach_marks("ˈ" + hit) + tail_ipa
    return None


def _letter_to_sound(word: str) -> str:
    """Rule-of-thumb grapheme-to-phoneme; last resort for OOV words."""
    out = ""
    i = 0
    w = word
    if w.startswith("x"):
        # word-initial x reads /z/ (xylophone, xenon, xerox); the greek
        # xy- prefix keeps its long vowel (the uppercase sentinel is the
        # magic-e long-vowel convention of the rule table)
        w = ("zI" + w[2:]) if w.startswith("xy") else ("z" + w[1:])
    if w.startswith(("gn", "ps", "pn", "mn")) and len(w) > 3:
        w = w[1:]  # silent initial letter (gnome, pseudo, pneumonia)
    # syllabic-l spellings: final -Cle reads /Cəl/ (handle, hornswoggle)
    w = re.sub(r"([bcdfgkpstz])le$", r"\1əl", w)
    if w.startswith("mc"):
        w = "mək" + w[2:]  # mcdonald, mcguffin
    if w.endswith("ture") and len(w) > 4:
        # handle before the magic-e strip would turn it into tUr -> tjur
        return _add_default_stress(_letter_to_sound(w[:-4]) + "ʧər")
    # silent final e lengthens the previous vowel (magic e: blaze -> bleɪz,
    # glide -> glaɪd); uppercase marks the long vowel for the rule table.
    # Keep the e after soft c/g so the dge/ce/ge rules fire (bridge, office)
    if (len(w) > 3 and w.endswith("e") and w[-2] not in "aeiou"
            and not w.endswith(("dge", "ce", "ge"))):
        w = w[:-1]
        if (len(w) >= 2 and w[-2] in "aeiou" and
                (len(w) < 3 or w[-3] not in "aeiou")):
            w = w[:-2] + w[-2].upper() + w[-1]
    elif (len(w) > 3 and w.endswith(("ce", "ge")) and w[-3] in "aeiou"
            and (len(w) < 5 or w[-4] not in "aeiou")):
        # magic e through soft c/g: nice -> naɪs, page -> peɪʤ
        w = w[:-3] + w[-3].upper() + w[-2:]
    while i < len(w):
        # context-sensitive cases the flat rule list cannot express
        if w[i] == "c" and i + 1 < len(w) and w[i + 1] in "eiy":
            out += "s"  # soft c (cell, city, cycle)
            i += 1
            continue
        if w[i] == "g" and i + 1 < len(w) and w[i + 1] in "ey":
            out += "ʤ"  # soft g (page, gym); gi- kept hard (give, girl)
            i += 1
            continue
        if w[i] == "e" and i == len(w) - 1 and i > 0 and w[i - 1] in "cg":
            i += 1  # silent final e kept for the soft c/g context
            continue
        if w[i] == "y":
            out += "j" if i == 0 else ("i" if i == len(w) - 1 else "ɪ")
            i += 1
            continue
        if w[i] == "a" and i == len(w) - 1 and i > 0:
            out += "ə"  # word-final a is a schwa (sofa, data, NASA)
            i += 1
            continue
        if w[i] == "o" and i == len(w) - 1 and i > 0:
            out += "oʊ"  # word-final o is long (hero, photo, pseudo)
            i += 1
            continue
        for pat, rep in _LTS_RULES:
            if w.startswith(pat, i):
                out += rep
                i += len(pat)
                break
        else:
            out += w[i]
            i += 1
    # doubled consonant letters are one sound (umbrella, thrapple)
    return _add_default_stress(re.sub(r"([bdfgklmnprstvz])\1", r"\1", out))


def _text_to_ipa_backend(text: str) -> str:
    try:
        import eng_to_ipa

        phonemes = eng_to_ipa.convert(text)
        return _oov_to_ipa(phonemes)
    except ImportError:
        words = re.findall(r"[a-z']+|[^a-z' ]+| ", text)
        return "".join(
            _word_to_ipa_fallback(w) if re.match(r"^[a-z']+$", w) else w
            for w in words
        )


def _oov_to_ipa(text: str) -> str:
    """Words eng_to_ipa marked with `*` -> g2p_en + ARPA->IPA
    (reference english.py:109-122)."""
    matches = re.findall(r"\s([\w|']+\*)", text) + re.findall(r"^([\w|']+\*)", text)
    if not matches:
        return text
    try:
        from g2p_en import G2p

        g2p = G2p()
        for word in matches:
            ipa = "".join(
                ARPA_TO_IPA.get(ph.lower().rstrip("012345"), ph.lower())
                for ph in g2p(word.rstrip("*"))
            )
            text = text.replace(word, ipa)
    except ImportError:
        for word in matches:
            text = text.replace(word, _word_to_ipa_fallback(word.rstrip("*")))
    return text


# letter-name words for acronym spell-out; their IPA lives in the lexicon
_LETTER_WORDS = {
    "a": "ay", "b": "bee", "c": "cee", "d": "dee", "e": "ee", "f": "ef",
    "g": "gee", "h": "aitch", "i": "eye", "j": "jay", "k": "kay",
    "l": "el", "m": "em", "n": "en", "o": "oh", "p": "pee", "q": "cue",
    "r": "ar", "s": "ess", "t": "tee", "u": "yu", "v": "vee",
    "w": "doubleyu", "x": "ex", "y": "why", "z": "zee",
}
_LETTER_NAME_IPA = {
    "ay": "eɪ", "bee": "bi", "cee": "si", "dee": "di", "ee": "i",
    "ef": "ɛf", "gee": "ʤi", "aitch": "eɪʧ", "eye": "aɪ", "jay": "ʤeɪ",
    "kay": "keɪ", "el": "ɛl", "em": "ɛm", "en": "ɛn", "oh": "oʊ",
    "pee": "pi", "cue": "kju", "ar": "ɑr", "ess": "ɛs", "tee": "ti",
    "yu": "ju", "vee": "vi", "doubleyu": "ˈdəbəlju", "ex": "ɛks",
    "why": "waɪ", "zee": "zi",
}
_LEXICON.update(_LETTER_NAME_IPA)


def _spell_acronyms(text: str) -> str:
    """ALL-CAPS tokens read as letter names: TTS -> tee tee ess. Runs
    before lowercasing — case is the only signal. Short caps words and
    vowel-less caps spell out; longer pronounceable initialisms (NASA)
    read as words; ordinary lexicon words typed in caps stay words."""

    def repl(m):
        word = m.group(0)
        lower = word.lower()
        if lower in _LEXICON and len(word) > 2:
            return lower
        if len(word) <= 3 or not any(c in "aeiou" for c in lower):
            return " ".join(_LETTER_WORDS[c] for c in lower if c in _LETTER_WORDS)
        return lower

    return re.sub(r"\b[A-Z]{2,}\b", repl, text)


def english_to_ipa(text: str) -> str:
    """Main entry (reference english.py:69-85)."""
    text = text.replace("-", " ")
    text = _strip_accents(text)
    text = _spell_acronyms(text)
    text = text.lower()
    text = expand_abbreviations(text)
    text = normalize_numbers_en(text)
    phonemes = _text_to_ipa_backend(text)
    phonemes = collapse_whitespace(phonemes)
    text = mark_dark_l(phonemes)
    for regex, replacement in _ipa_to_ipa2:
        text = regex.sub(replacement, text)
    return text.replace("...", "…")
