"""serve.queue_ms: the mean time from a request's due time to the start of
the ``synthesize_batch`` call that carries it (the batcher's queue and flush
wait), in ms."""


def read(ctx):
    return None if ctx.get("queue_s") is None else ctx["queue_s"] * 1e3
