"""CUDA graphs of the engine's budgeted ``SynthesizerTrn.infer``, sized to
the frames the call's rows need.

A budgeted call runs at a static shape (rows padded to a batch bucket, text
to a text bucket, frames to the engine's frame budget M), so it is a fixed
chain of a few thousand small launches; at batch 1 the host's dispatch of
them, not the device, sets its pace. ``InferGraphs`` captures each call in
two stages and replays them after:

- Stage 1, one graph per (rows, text bucket, M): the text encoder, the SDP
  in reverse, the predicted lengths and the prior expanded over M frames
  (``SynthesizerTrn._infer_text``).
- One host read: the longest predicted length, which sets the frames F the
  call decodes (``sized_frames``): the smallest multiple of ``FRAME_STEP``
  that holds it, at most M. Under M = 1000 the ladder is 128, 256, ..., 896,
  1000. A saturated row (length M) decodes at M, as before.
- Stage 2, one graph per (rows, F): the prior sample, the reverse flow, the
  scope crop and the decoder over F frames (``_infer_frames``). Its inputs
  are stage 1's outputs and the prior noise cut to their first F frames,
  copied on the device into the graph's own buffers, so that its key holds
  no text bucket and every M a call can have shares it.

The call returns the audio of F frames, [rows, F * hop, 1]; the engine keeps
each row's first y_len x hop samples. Stage 2 at F computes what the eager
call at ``max_frames`` F computes, kernel for kernel (the expanded prior's
first F frames do not depend on M), so the replay's audio is
``_infer(..., max_frames=F)``'s, bit for bit. Against the eager call at M the
kept audio differs in the convolutions' rounding (cuDNN picks its algorithms
by length) and in a row's last frames within the decoder's reach of F (13
frames for ``configs/config_cje.yaml``'s HiFi-GAN, 24 for the LJSpeech
multi-band iSTFT decoder): past F the decoder sees zeros where, decoded at
M, it saw the padding frames' activations.

First call at a key: the stage's values go into static input buffers, one
eager warm-up runs on a side stream, the stage is captured into a
``torch.cuda.CUDAGraph`` (``capture_error_mode="thread_local"``, so other
serving threads may go on working) and the graph is replayed. Later calls
copy the values into the buffers (``copy_``) and replay. The per-row controls
(``length_scale``, ``scope_shift``) are [rows] tensor inputs, never baked in:
one graph serves every duration and shift (a call that gives them as numbers
runs eagerly, at M).

Invariants:

- One lock covers a call: both stages' copy-in and replay, the host read,
  the read-out, and any capture. Graphs share one memory pool, so a replay
  may overwrite another graph's outputs: stage 1's outputs are copied into
  stage 2's buffers, and the lengths out, before stage 2 replays, and each
  call's outputs are copied out before the lock is let go. A call on another
  stream than the last read-out's waits for it first.
- Weights are read where they live: a change made in place
  (``load_state_dict``, ``Tensor.copy_``) is seen by the next replay of
  either stage; one that replaces a parameter's storage (``.to()``,
  ``assign=True``) is not.

Counters (``utils/profiling.py``): ``serve.graph_captures`` (each stage's
capture, so a call can add two) and ``serve.graph_replays`` (a call whose two
stages were both captured before it). The engine counts the frames decoded
from the audio's length and ``serve.sized_calls`` (calls decoded at F < M).
"""

from __future__ import annotations

import threading

import torch

from vits_torch.utils.profiling import count

NOISE = ("sdp_noise", "eps")
# the rungs of the ladder of sized frame budgets
FRAME_STEP = 128


def sized_frames(longest: int, cap: int) -> int:
    """The frames a call decodes: the smallest multiple of ``FRAME_STEP``
    that holds ``longest`` (its longest row's predicted length, at least 1),
    at most ``cap`` (the budget the engine asked for)."""
    return min(cap, -(-max(longest, 1) // FRAME_STEP) * FRAME_STEP)


class InferGraphs:
    """The graph cache a model's ``infer`` replays from (see the module
    docstring); ``model.infer_graphs = InferGraphs()`` turns it on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._graphs: dict[tuple, tuple] = {}  # key -> (graph, inputs, outputs)
        self._pool = None
        self._done = None  # recorded after each read-out

    @staticmethod
    def takes(x, noise, generator, length_scale, scope_shift) -> bool:
        """A call the cache can serve: on a CUDA device, with every draw
        given and the controls as tensors, under ``torch.inference_mode()``."""
        return (x.is_cuda and generator is None and noise is not None
                and all(k in noise for k in NOISE)
                and isinstance(length_scale, torch.Tensor) and isinstance(scope_shift, torch.Tensor)
                and torch.is_inference_mode_enabled())

    def __call__(self, model, x, t, x_lengths, sid, noise, length_scale, scope_shift, *,
                 noise_scale, noise_scale_w, max_frames):
        """``model.infer``'s call replayed in its two stages (``model._infer_text``
        and ``model._infer_frames``): (waveform [rows, F * hop, 1], y_mask
        [rows, F, 1], y_lengths [rows])."""
        rows = x.shape[0]

        def text(**v):
            return model._infer_text(**v, noise_scale_w=noise_scale_w, max_frames=max_frames)

        def frames(**v):
            return model._infer_frames(**v, noise_scale=noise_scale)

        with self._lock:
            stream = torch.cuda.current_stream(x.device)
            if self._done is None:
                self._done = torch.cuda.Event()
            else:
                stream.wait_event(self._done)
            (m_p, logs_p, y_lengths, g), new_text = self._run(
                ("text", tuple(x.shape), sid is None, noise_scale_w, max_frames), text,
                {"x": x, "t": t, "x_lengths": x_lengths, "sid": sid,
                 "sdp_noise": noise["sdp_noise"], "length_scale": length_scale}, x.device)
            f = sized_frames(int(y_lengths.max()), max_frames)  # the one host read
            lengths = y_lengths.clone()
            (wav, y_mask), new_frames = self._run(
                ("frames", rows, f, g is None, noise_scale), frames,
                {"m_p": m_p[:, :f], "logs_p": logs_p[:, :f], "y_lengths": y_lengths, "g": g,
                 "eps": noise["eps"][:, :f], "scope_shift": scope_shift}, x.device)
            out = (wav.clone(), y_mask.clone(), lengths)
            self._done.record(stream)
            if not (new_text or new_frames):
                count("serve.graph_replays")
            return out

    def _run(self, key, fn, values: dict, dev):
        """``fn(**values)`` replayed from the graph at ``key``, captured first
        if there is none: (its static outputs, whether this call captured)."""
        if key in self._graphs:
            graph, inputs, outputs = self._graphs[key]
            for name, buf in inputs.items():
                buf.copy_(values[name])
            new = False
        else:  # the capture loads the buffers itself
            graph, _, outputs = self._graphs[key] = self._capture(fn, values, dev)
            count("serve.graph_captures")
            new = True
        graph.replay()
        return outputs, new

    def _capture(self, fn, values: dict, dev) -> tuple:
        inputs = {name: torch.empty(v.shape, dtype=v.dtype, device=dev).copy_(v)
                  for name, v in values.items() if v is not None}

        def run():
            return fn(**{name: inputs.get(name) for name in values})

        # warm-up: lazy initialisation (cuDNN, cuBLAS) stays out of the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            outputs = run()
        return graph, inputs, tuple(outputs)
