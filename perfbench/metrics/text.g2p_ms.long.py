"""text.g2p_ms.long: host ms in ``TTSEngine.get_phoneme`` per request of the window."""


def read(ctx):
    return ctx["g2p_s"] / ctx["requests"] * 1e3 if ctx.get("g2p_calls") else None
