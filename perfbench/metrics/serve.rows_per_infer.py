"""serve.rows_per_infer: the window's requests over its ``model.infer``
calls (a flush split by bucket, and a request that escalates, lower it)."""


def read(ctx):
    return ctx["requests"] / ctx["infer_calls"] if ctx.get("infer_calls") else None
