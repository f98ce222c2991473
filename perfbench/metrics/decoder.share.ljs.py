"""decoder.share.ljs: the waveform decoder's share of the device time of a
paragraph run eagerly, 100 x device seconds of the span ``decode`` (the
decoder's ``forward``) / those of the span ``infer_eager`` (``model.infer``),
in percent. Nothing without the eager stretch."""


def read(ctx):
    spans = (ctx.get("eager_trace") or {}).get("spans", {})
    whole = spans.get("infer_eager", {}).get("device_s")
    if not whole:
        return None
    return 100.0 * spans.get("decode", {}).get("device_s", 0.0) / whole
