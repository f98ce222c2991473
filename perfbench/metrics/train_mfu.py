"""train_mfu: the FLOPs of the window's steps, counted on the reference at each
step's shapes, over the window's wall time (host clock, outside the profiler)
and the card's dense bf16 peak, in percent."""


def read(ctx):
    if not ctx.get("flops") or not ctx.get("peak_flops"):
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / ctx["peak_flops"]
