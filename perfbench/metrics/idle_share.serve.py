"""idle_share.serve: the share of the profiled stretch in which nothing ran on the
device: 1 - (union of kernel, copy and memset intervals) / the stretch's
length, in percent."""

from perfbench.tracing import idle_percent


def read(ctx):
    return idle_percent(ctx.get("trace", {}))
