"""engine.pad_share.long: the share of the frames the engine decoded that
are not audio, 100 x (1 - kept / decoded), over the profiled stretch: the
program's counters ``serve.frames_decoded`` (frame budget x rows of each
budgeted call) and ``serve.frames_kept`` (the real rows' predicted
lengths), in percent."""

from perfbench import program


def read(ctx):
    counters = program.snapshot().get("counters", {})
    decoded = counters.get("serve.frames_decoded")
    if not decoded:
        return None
    return 100.0 * (1.0 - counters.get("serve.frames_kept", 0) / decoded)
