"""engine.infer_calls.long: ``model.infer`` calls per paragraph of the window
(its pieces, and each frame-budget escalation of a piece)."""


def read(ctx):
    return ctx["infer_calls"] / ctx["requests"] if ctx.get("requests") else None
