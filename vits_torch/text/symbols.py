"""Model input symbol inventory — 71 ids (pad + punctuation + IPA + extras).

The port's own copy of ``vits_tpu/text/symbols.py``. This is the model's
vocabulary contract (reference text/symbols.py:5-14); ids must match for
checkpoint/text parity: pad `_`, punctuation, IPA letters incl. tone/accent
arrows, extras. The duplicated ``ˌ`` (in ``_letters`` and ``_extra``) is the
reference's quirk and is kept, so ``len(symbols)`` is 71.
"""

_pad = "_"
_punctuation = ",.!?-~…"
_letters = "NQabdefghijklmnopstuvwxyzɑæʃʑçɯɪɔɛɹðəɫɥɸʊɾʒθβŋɦ⁼ʰ`^#*=ˈˌ→↓↑ "
_extra = "ˌ%$"

symbols = [_pad] + list(_punctuation) + list(_letters) + list(_extra)

SPACE_ID = symbols.index(" ")
