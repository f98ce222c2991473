#!/usr/bin/env python3
"""Bisect the port's bf16 training policy: which group's bf16 compute, and
which rounding in it, makes the convergence study's MAS alignment drift.

The policy computes three groups in bfloat16 with f32 parameters: the
posterior encoders (``pe``), the HiFi-GAN decoder (``dec``) and the
discriminator (``disc``). A variant names the groups kept in bf16, joined by
``+`` (the others compute in f32; ``none`` keeps none), each with how it
rounds after a colon:

  round        as the package computes (the default): every op rounds its
               own output to bf16, the bias add after a conv included
  wgrad32      as ``round``, but each conv's weight gradient leaves the conv
               in f32 (the bf16 products accumulated and written in f32),
               not rounded to bf16 before the cast to the f32 parameter
  f32between   each conv rounds its input and weight to bf16 and
               accumulates and writes its output in f32; every op between
               the convs (bias adds, gated units, residual and skip sums,
               leaky ReLUs, MRF averages, the PQMF banks) computes in f32,
               and the gradients are rounded only where a conv's input is
  fused        as XLA's fusions write the JAX modules: each conv writes its
               output in bf16 once; what XLA fuses after it computes in f32
               from that output (the bias in f32) and rounds to bf16 once,
               where the fusion writes

e.g. ``pe``, ``dec+disc``, ``pe:wgrad32+dec:wgrad32+disc:wgrad32``,
``pe+dec+disc:f32between``, ``pe:fused+dec:fused+disc:fused``. The variants
patch the port's conv classes and, for ``fused``, the forwards of the
posterior encoder, the decoder and the discriminator's blocks, and the train
CLI's model builders, in this process; the package itself has no switch for
them and rounds as ``round``.

Where the fusions write (``fused``). ``tools/bf16_fusion_map.py`` lowers the
JAX ``PosteriorEncoder`` (16 WaveNet layers), ``ResBlock1`` and
``HiFiGANGenerator.hier_forward`` under bf16 with ``jax.jit(...).lower(...)
.compile().as_text()`` on the CPU and lists each fusion. In these modules
every fusion writes a conv's input, or a module's f32 output; everything
else is recomputed inside the fusions that read it, never written:

  posterior encoder (``vits_tpu/models/posterior_encoder.py:41-52``; port
  ``vits_torch/models/posterior_encoder.py:43-45``)
    P1 ``pre`` + bias, x mask: written as in_0's input; the residual stream
       (P3) recomputes it from the conv's output
    P2 gate (``vits_tpu/models/modules.py:236-252``; port
       ``vits_torch/models/modules.py:147-153``): in_i + bias + (cond +
       cond bias)[layer slice], tanh x sigmoid: one fusion, res_skip_i's input
    P3 residual (``modules.py:260``; port :157): x_0 + sum over j <= i of
       (res_skip_j + bias)[:h], x mask after each: one fusion, in_{i+1}'s
       input; it recomputes the stream from ``pre`` through layer i
    P4 skip sum (``modules.py:261,263-264``; port :158-161): the sum of every
       layer's (res_skip + bias)[h:] (the last layer's whole), x mask: one
       fusion, ``proj``'s input
    P5 ``proj`` + bias, x mask, to f32 (``posterior_encoder.py:50-52``):
       the stats, written in f32
  HiFi-GAN decoder (``vits_tpu/models/hifigan.py:27-157``; port
  ``vits_torch/models/hifigan.py:30-123``)
    D1 conv_pre + bias + cond + cond bias, leaky ReLU (:121-128; port
       :109-114): up_0's input
    D2 up_i + bias (:129-138; port :114), leaky ReLU: the input of each
       resblock's first conv;
       the up output itself is recomputed in every fusion that reads it
    D3 ResBlock (``hifigan.py:36-64``; port :38-50): conv1 + bias, leaky
       ReLU, x mask: conv2's input; the stream x + conv2 + bias, leaky
       ReLU, x mask: the next conv1's input; the stream is never written
    D4 MRF (:141-145; port :115-119): the three resblock streams summed and
       divided by 3, leaky ReLU: the next up conv's input, and (heads)
       with the default slope: each conv_post's input
    D5 tanh(conv_post), to f32 (:147-157; port :121-123): the waveform, f32
  discriminator (``vits_tpu/models/avocodo.py:54,173,180``; port
  ``vits_torch/models/avocodo.py:68,72,171-173,196``; assumed as below)
    A1 a CoMBD conv + bias, leaky ReLU: the feature map and the next input;
       the projection + bias
    A2 an MDC's branches, each + bias and leaky ReLU, summed: post_conv's
       input; post_conv + bias, leaky ReLU; an SBD block's post conv + bias

What the CPU's HLO shows and what is assumed for the TPU:
  shown     which ops each fusion holds, that each writes only the inputs
            of convs (and the f32 outputs) named above, and that the
            streams (P3, D3, D4) are recomputed, not written; that a conv's
            output is read rounded to bf16 (the CPU computes its bf16 convs
            in f32 and rounds on the first read)
  assumed   that a fusion computes in f32 between its reads and its write.
            The CPU's compiled HLO rounds to bf16 after every op inside a
            fusion (a convert pair per op), so it reads as ``round``; f32
            inside a fusion (XLA's excess precision, which also leaves the
            bias and the f32 outputs P5, D5 unrounded) is assumed for the
            TPU's fusions, in D as in the generator. Also assumed: the conv
            writes its bf16 output before the bias add; a TPU conv output
            fusion that folds the bias and the activation into the conv's
            epilogue would round the f32 accumulator once instead of twice
            (the card's cuDNN convs write bf16, so the tool rounds twice).

The fused epilogues are ``torch.autograd.Function``s that save only bf16
activations: the conv outputs (which the conv had already produced), the
rounded results, g's slice and the bf16 mask; a bias the backward needs is
saved as the parameter itself (no copy). ``backward`` recomputes the f32
chain and returns the gradient in the input's dtype; a leaky ReLU's slope
comes from the sign of its rounded output, which rounding keeps. The
streams between fusions are f32 tensors the graph does not keep. Beside each
Function its plain version computes the same chain in f32 through autograd
and rounds with ``.to`` (the tests compare the two). These are short
elementwise chains in a study tool, not a port of a TPU kernel, so they are
plain PyTorch, not CUDA or Triton.

Subcommands (run from the repo root, on the card unless ``--device cpu``):

  gaps   one train step at the study's width (B=2, 160 and 120 frames) on
         the CPU and on the card from the same weights, batch, noise and
         PhaseAug draws, MAS on the CPU f32 step's path, TF32 off, cuDNN
         deterministic: the forward and gradient gap of each group under
         bf16 (card and CPU, ``--variant``'s rounding) and f32 (card)
         against the CPU's f32 step
  phase12  ``chip_smoke.py`` phase 12 alone, with its seed (card against CPU
         under bf16 at the tiny configuration); ``--fault K`` first makes the card's bf16
         convs (ungrouped, >= 2K input channels) sum K split-K partials
         that are each rounded to bf16, a fault a bf16 reduction would
         make, to show the phase's tolerance catches it
  train  ``tools/convergence_torch.py``'s study training under a variant:
         --workdir W --variant V --steps N --seed S; ``gen`` first if W has
         no corpus, a resumed run if W holds checkpoints; then that tool's
         ``analyze`` and ``synth`` on W, and the run's result
         (``<variant>@<seed>.json`` in ``--out``, else in W): the rows, the
         held-out check and ``held``
  rates  the hold rate of each variant: --runs V@S,V@S,... --root R --out O;
         every run in its own workdir R/<variant>@<seed> (a run whose
         result is in O is skipped; one with checkpoints resumes),
         side by side on the one card: --jobs at first, then as many as keep each run at <= 2 s a step
         and let every run finish by --deadline-s; then the
         tally of every run in O and of the earlier runs of 2400 steps or
         more in ``docs/convergence_torch_runs.json``: per variant the runs
         and those held (boundary MAE <= 2.8 frames at steps 2000 and
         2400), Fisher's exact one-sided p of each bf16 variant holding
         more often than the package and of f32 holding more often than the
         package, and the verdict by ROADMAP.md's rule
  tally  the tally of the runs JSON's runs (and of those in --out, if
         given)

Every line the card prints carries its name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import torch
from torch.nn import functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = ("pe", "dec", "disc")
MODES = ("round", "wgrad32", "f32between", "fused")
STUDY_STEPS_PER_EPOCH = 17  # 256 training utterances in B=16 buckets
BF16, F32 = torch.bfloat16, torch.float32

PACKAGE, F32_POLICY = "pe+dec+disc", "none"
HOLD_FRAMES, HOLD_STEPS = 2.8, (2000, 2400)  # a run holds: boundary MAE at both steps
SOLO_STEP_S = 0.55  # a study step alone on the card (runs alone took 0.42-0.54 s)
MAX_STEP_S = 2.0  # rates: no run slower than this a step
MAX_JOBS = 10  # rates: runs on the card at once (a run's peak is 5.7-6.7 GiB of 80)
RUNS_JSON = os.path.join(ROOT, "docs", "convergence_torch_runs.json")


def parse_variant(name: str) -> dict:
    """{group: mode} of the groups a variant keeps in bf16."""
    kept = {}
    for spec in name.split("+"):
        group, _, mode = spec.partition(":")
        if group in ("", "none"):
            continue
        if group not in GROUPS or (mode or "round") not in MODES:
            raise SystemExit(f"variant {name!r}: groups from {GROUPS} joined by '+', "
                             f"each with ':mode', a mode from {MODES}")
        kept[group] = mode or "round"
    return kept


def canonical(name: str) -> str:
    """The variant's name in group order, ':round' left out; 'none' for f32."""
    kept = parse_variant(name)
    return "+".join(g if kept[g] == "round" else f"{g}:{kept[g]}"
                    for g in GROUPS if g in kept) or F32_POLICY


# -- the fused epilogues: autograd Functions and their plain versions --------------


def _affine_math(dtype, div, mask, *terms):
    z = terms[0].float()
    for t in terms[1:]:
        z = z + t.float()
    if mask is not None:
        z = z * mask.float()
    if div != 1:
        z = z / div
    return z.to(dtype)


def _lrelu_math(slope, mask, z):
    y = F.leaky_relu(z.float(), slope)
    return (y if mask is None else y * mask.float()).to(BF16)


def _gate_math(h, c, b, g, gb):
    a = c.float() + b[:, None]
    if g is not None:
        a = a + (g.float() + gb[:, None])
    return (torch.tanh(a[:, :h]) * torch.sigmoid(a[:, h:])).to(BF16)


def _branch_sum_math(slope, *cb):
    out = None
    for c, b in zip(cb[::2], cb[1::2]):
        y = F.leaky_relu(c.float() + b[:, None], slope)
        out = y if out is None else out + y
    return out.to(BF16)


def _tanh_math(c):
    return torch.tanh(c.float())


class _Affine(torch.autograd.Function):
    """(the sum of ``terms``) x ``mask`` / ``div`` in f32, returned in
    ``dtype``: one rounding to bf16, or an f32 stream. Saves the mask."""

    @staticmethod
    def forward(ctx, dtype, div, mask, *terms):
        ctx.save_for_backward(mask)
        ctx.div, ctx.like = div, [(t.shape, t.dtype) for t in terms]
        return _affine_math(dtype, div, mask, *terms)

    @staticmethod
    def backward(ctx, dy):
        (mask,) = ctx.saved_tensors
        g = dy.float()
        if mask is not None:
            g = g * mask.float()
        if ctx.div != 1:
            g = g / ctx.div
        grads = [g.sum_to_size(shape).to(dt) if need else None
                 for (shape, dt), need in zip(ctx.like, ctx.needs_input_grad[3:])]
        return (None, None, None, *grads)


class _LReLU(torch.autograd.Function):
    """leaky_relu(z) x ``mask`` in f32, rounded to bf16 once. Saves the
    rounded output (its sign gives the slope) and the mask."""

    @staticmethod
    def forward(ctx, slope, mask, z):
        out = _lrelu_math(slope, mask, z)
        ctx.save_for_backward(out, mask)
        ctx.slope, ctx.dtype = slope, z.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        out, mask = ctx.saved_tensors
        g = dy.float() * torch.where(out > 0, 1.0, ctx.slope)
        if mask is not None:
            g = g * mask.float()
        return None, None, g.to(ctx.dtype)


class _Gate(torch.autograd.Function):
    """tanh(a[:h]) x sigmoid(a[h:]), a = (c + b) + (g + gb) in f32, rounded
    to bf16 once: the WaveNet gate (P2). Saves c and g (bf16) and the
    biases (parameters); backward recomputes ``a``."""

    @staticmethod
    def forward(ctx, h, c, b, g, gb):
        ctx.save_for_backward(c, b, g, gb)
        ctx.h = h
        return _gate_math(h, c, b, g, gb)

    @staticmethod
    def backward(ctx, dy):
        c, b, g, gb = ctx.saved_tensors
        h = ctx.h
        a = c.float() + b[:, None]
        if g is not None:
            a = a + (g.float() + gb[:, None])
        t, s = torch.tanh(a[:, :h]), torch.sigmoid(a[:, h:])
        gy = dy.float()
        da = torch.cat([gy * s * (1 - t * t), gy * t * s * (1 - s)], dim=1)
        db = da.sum((0, 2))
        return (None, da.to(c.dtype), db.to(b.dtype),
                None if g is None else da.sum(2, keepdim=True).to(g.dtype),
                None if g is None else db.to(gb.dtype))


class _BranchSum(torch.autograd.Function):
    """The sum over branches of leaky_relu(c_k + b_k) in f32, rounded to
    bf16 once: an MDC's branches (A2). Saves each c_k (bf16) and b_k
    (parameter); backward recomputes each branch's sign."""

    @staticmethod
    def forward(ctx, slope, *cb):
        ctx.save_for_backward(*cb)
        ctx.slope = slope
        return _branch_sum_math(slope, *cb)

    @staticmethod
    def backward(ctx, dy):
        cb = ctx.saved_tensors
        gy, grads = dy.float(), []
        for c, b in zip(cb[::2], cb[1::2]):
            d = gy * torch.where(c.float() + b[:, None] > 0, 1.0, ctx.slope)
            grads += [d.to(c.dtype), d.sum((0, 2)).to(b.dtype)]
        return (None, *grads)


class _Tanh(torch.autograd.Function):
    """tanh of a bf16 conv output, written in f32 (D5). Saves the conv
    output; backward recomputes the tanh."""

    @staticmethod
    def forward(ctx, c):
        ctx.save_for_backward(c)
        return _tanh_math(c)

    @staticmethod
    def backward(ctx, dy):
        (c,) = ctx.saved_tensors
        t = torch.tanh(c.float())
        return (dy.float() * (1 - t * t)).to(c.dtype)


def affine(dtype, mask, *terms, div=1):
    return _Affine.apply(dtype, div, mask, *terms)


def lrelu(slope, mask, z):
    return _LReLU.apply(slope, mask, z)


def gate(h, c, b, g=None, gb=None):
    return _Gate.apply(h, c, b, g, gb)


def branch_sum(slope, *cb):
    return _BranchSum.apply(slope, *cb)


def tanh32(c):
    return _Tanh.apply(c)


# {Function: its plain version}: the same chain through autograd, one ``.to``
PLAIN = {
    _Affine: lambda dtype, div, mask, *terms: _affine_math(dtype, div, mask, *terms),
    _LReLU: _lrelu_math,
    _Gate: _gate_math,
    _BranchSum: _branch_sum_math,
    _Tanh: _tanh_math,
}


# -- conv marks --------------------------------------------------------------------


class _WGrad32(torch.autograd.Function):
    """bf16 conv (no bias) whose input gradient is the bf16 conv's and whose
    weight gradient is accumulated and returned in f32."""

    @staticmethod
    def forward(ctx, x, weight, params):
        wb = weight.to(torch.bfloat16)
        ctx.save_for_backward(x, wb)
        ctx.params = params
        return torch.ops.aten.convolution(x, wb, None, *params)

    @staticmethod
    def backward(ctx, dy):
        x, wb = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                dy, x, wb, None, *ctx.params, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            # bf16 operands are exact in f32 (and in TF32): exact products, f32 sums
            dw = torch.ops.aten.convolution_backward(
                dy.float(), x.float(), wb.float(), None, *ctx.params, [False, True, False])[1]
        return dx, dw, None


def _conv_params(conv) -> tuple:
    transposed = isinstance(conv, torch.nn.ConvTranspose1d)
    return (conv.stride, conv.padding, conv.dilation, transposed,
            conv.output_padding if transposed else (0,), conv.groups)


def _ablated_conv(conv, x, weight, bias, plain):
    mode = getattr(conv, "_ablation", None)
    if mode == "f32between":
        xb, wb = (t.to(torch.bfloat16).float() for t in (x, weight))
        return torch.ops.aten.convolution(xb, wb, bias, *_conv_params(conv))
    if mode == "wgrad32" and x.dtype == torch.bfloat16:
        y = _WGrad32.apply(x, weight, _conv_params(conv))
        return y if bias is None else y + bias.to(y.dtype)[:, None]
    if mode == "fused" and x.dtype == torch.bfloat16:
        # the conv's output as the conv writes it, rounded once; the caller's
        # fused epilogue adds the bias
        return torch.ops.aten.convolution(x, weight.to(x.dtype), None, *_conv_params(conv))
    return plain()


def _bias(conv):
    return conv.bias[:, None]


def _fused(module) -> bool:
    return getattr(module, "_fused", False)


# -- the fused forwards --------------------------------------------------------------


def patch_discriminator() -> None:
    """Make a fused discriminator's blocks round once a fusion (A1, A2); an
    unmarked block computes as the package's."""
    from vits_torch.models import avocodo

    slope = avocodo.LRELU
    combd, mdc, sbd = avocodo.CoMBDBlock.forward, avocodo.MDC.forward, avocodo.SBDBlock.forward

    def combd_forward(self, x, b_y, b_y_hat):
        if not _fused(self):
            return combd(self, x, b_y, b_y_hat)
        fmap_r, fmap_g = [], []
        tile = b_y < b_y_hat
        for conv in self.convs:
            x = lrelu(slope, None, affine(F32, None, conv(x), _bias(conv)))
            f_r, f_g = x[:b_y], x[b_y:]
            fmap_r.append(f_r.repeat(2, 1, 1) if tile else f_r)
            fmap_g.append(f_g)
        x = affine(BF16, None, self.projection_conv(x), _bias(self.projection_conv))
        x_r, x_g = x[:b_y], x[b_y:]
        return (x_r.repeat(2, 1, 1) if tile else x_r), x_g, fmap_r, fmap_g

    def mdc_forward(self, x):
        if not _fused(self):
            return mdc(self, x)
        out = branch_sum(slope, *[t for conv in self.d_convs for t in (conv(x), conv.bias)])
        return lrelu(slope, None, affine(F32, None, self.post_conv(out), _bias(self.post_conv)))

    def sbd_forward(self, x):
        if not _fused(self):
            return sbd(self, x)
        fmap_r, fmap_g = [], []
        half = x.shape[0] // 2
        for conv in self.convs:
            x = conv(x)
            fmap_r.append(x[:half])
            fmap_g.append(x[half:])
        x = affine(BF16, None, self.post_conv(x), _bias(self.post_conv))
        return x[:half], x[half:], fmap_r, fmap_g

    avocodo.CoMBDBlock.forward = combd_forward
    avocodo.MDC.forward = mdc_forward
    avocodo.SBDBlock.forward = sbd_forward


def wavenet_fused(wn, x32, mask, g=None):
    """The WaveNet stack from its f32 input stream: P2-P4; returns the skip
    sum as written, bf16 (``proj``'s input)."""
    h = wn.hidden_channels
    gr = wn.cond_layer(g) if g is not None else None
    skip = None
    for i, (inl, res) in enumerate(zip(wn.in_layers, wn.res_skip_layers)):
        sl = slice(i * 2 * h, (i + 1) * 2 * h)
        c = inl(x32.to(BF16))
        acts = wn.drop(gate(h, c, inl.bias, *(() if gr is None else
                                             (gr[:, sl], wn.cond_layer.bias[sl]))))
        r = res(acts)
        if i < wn.n_layers - 1:
            x32 = affine(F32, mask, x32, r[:, :h], res.bias[:h, None])
            part = (r[:, h:], res.bias[h:, None])
        else:
            part = (r, _bias(res))
        skip = affine(F32, None, *part) if skip is None else affine(F32, None, skip, *part)
    return affine(BF16, mask, skip)


def resblock_fused(rb, x32, mask=None):
    """A HiFi-GAN resblock on an f32 stream (D3); returns the f32 stream."""
    from vits_torch.models.hifigan import ResBlock1
    from vits_torch.models.modules import LRELU_SLOPE as slope

    if isinstance(rb, ResBlock1):
        for c1, c2 in zip(rb.convs1, rb.convs2):
            t = c1(lrelu(slope, mask, x32))
            t = c2(lrelu(slope, mask, affine(F32, None, t, _bias(c1))))
            x32 = affine(F32, None, t, _bias(c2), x32)
    else:
        for c in rb.convs:
            x32 = affine(F32, None, c(lrelu(slope, mask, x32)), _bias(c), x32)
    return x32 if mask is None else affine(F32, mask, x32)


def patch_generator() -> None:
    """Make a fused posterior encoder (P1-P5) and a fused decoder (D1-D5)
    round once a fusion; unmarked ones compute as the package's."""
    from vits_torch.models import hifigan, posterior_encoder
    from vits_torch.models.modules import LRELU_SLOPE
    from vits_torch.ops.commons import sequence_mask

    pe, body = posterior_encoder.PosteriorEncoder.forward, hifigan.HiFiGANGenerator._body

    def pe_forward(self, x, x_lengths, g=None, eps=None):
        if not _fused(self):
            return pe(self, x, x_lengths, g=g, eps=eps)
        x_mask = sequence_mask(x_lengths, x.shape[2]).unsqueeze(1).to(F32)
        x, mask = x.to(BF16), x_mask.to(BF16)
        g = g.to(BF16) if g is not None else None
        h32 = affine(F32, mask, self.pre(x), _bias(self.pre))
        h = wavenet_fused(self.enc, h32, mask, g)
        stats = affine(F32, mask, self.proj(h), _bias(self.proj))
        m, logs = torch.split(stats, self.out_channels, dim=1)
        z = m * x_mask if eps is None else (m + eps * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask

    def dec_body(self, x, g, hier: bool):
        if not _fused(self):
            return body(self, x, g, hier)
        x = x.to(BF16)
        terms = [self.conv_pre(x), _bias(self.conv_pre)]
        if g is not None:
            terms += [self.cond(g.to(BF16)), _bias(self.cond)]
        x32 = affine(F32, None, *terms)
        outs = []
        first_head = self.num_upsamples - 3
        for i, up in enumerate(self.ups):
            u32 = affine(F32, None, up(lrelu(LRELU_SLOPE, None, x32)), _bias(up))
            k = self.num_kernels
            rs = [resblock_fused(self.resblocks[i * k + j], u32) for j in range(k)]
            x32 = affine(F32, None, *rs, div=k)
            if (hier and i >= first_head) or i == self.num_upsamples - 1:
                post = self.conv_posts[i - first_head]
                outs.append(tanh32(post(lrelu(0.01, None, x32))))
        return outs

    posterior_encoder.PosteriorEncoder.forward = pe_forward
    hifigan.HiFiGANGenerator._body = dec_body


def patch_convs() -> None:
    """Route the port's conv classes through ``_ablated_conv`` (a conv
    without an ``_ablation`` mark computes as before)."""
    from vits_torch.models import modules

    conv_fwd = modules.Conv1d._conv_forward
    tconv_fwd = modules.ConvTranspose1d.forward

    def conv_forward(self, x, weight, bias):
        return _ablated_conv(self, x, weight, bias, lambda: conv_fwd(self, x, weight, bias))

    def tconv_forward(self, x):
        return _ablated_conv(self, x, self.weight, self.bias, lambda: tconv_fwd(self, x))

    modules.Conv1d._conv_forward = conv_forward
    modules.ConvTranspose1d.forward = tconv_forward


def apply_variant(parts: dict, kept: dict) -> None:
    """Set the bf16 flag, the convs' marks and the fused marks of each group
    in ``parts`` ({group: [modules]}) under the bf16 policy."""
    from vits_torch.models.modules import Conv1d, ConvTranspose1d

    for group, mods in parts.items():
        mode = kept.get(group)
        for m in mods:
            m.bf16 = mode is not None and mode != "f32between"
            for c in m.modules():
                c._fused = mode == "fused"
                if isinstance(c, (Conv1d, ConvTranspose1d)):
                    c._ablation = mode if mode not in (None, "round") else None


def model_parts(model) -> dict:
    return {"pe": [model.posterior_encoder, model.pitch_encoder],
            "dec": [model.waveform_decoder]}


def patch_builders(kept: dict) -> None:
    """Make the train CLI, ``build_synthesizer`` and ``AvocodoDiscriminator``
    build their generator and discriminator under the variant (when they
    build for the bf16 policy)."""
    from vits_torch.models import avocodo, synthesizer
    from vits_torch.training import train as cli

    build_g, build_d = cli.build_synthesizer, cli.build_discriminator

    def build_synthesizer(hps, device=None, bf16=False):
        model = build_g(hps, device=device, bf16=bf16)
        if bf16:
            apply_variant(model_parts(model), kept)
        return model

    def build_discriminator(hps, bf16, device):
        disc = build_d(hps, bf16, device)
        if bf16:
            apply_variant({"disc": [disc]}, kept)
        return disc

    class Discriminator(avocodo.AvocodoDiscriminator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if self.bf16:
                apply_variant({"disc": [self]}, kept)

    cli.build_synthesizer, cli.build_discriminator = build_synthesizer, build_discriminator
    synthesizer.build_synthesizer = build_synthesizer
    avocodo.AvocodoDiscriminator = Discriminator


def install(variant: str) -> dict:
    """Patch this process so that what it builds for the bf16 policy
    computes under ``variant``; returns its {group: mode}."""
    kept = parse_variant(variant)
    patch_convs()
    patch_discriminator()
    patch_generator()
    patch_builders(kept)
    return kept


# -- the study ------------------------------------------------------------------------


def held(rows: list[dict]) -> bool | None:
    """Boundary MAE <= HOLD_FRAMES at every step of HOLD_STEPS; None when a
    step is missing (the run stopped before it)."""
    mae = {r["step"]: r["mas_boundary_mae"] for r in rows}
    if any(s not in mae for s in HOLD_STEPS):
        return None
    return all(mae[s] <= HOLD_FRAMES for s in HOLD_STEPS)


def train(workdir: str, variant: str, steps: int, seed: int, device=None, out=None) -> dict:
    """The study's training under ``variant`` for at least ``steps`` steps
    (whole epochs), ``train.seed`` = ``seed``, then its analysis and
    held-out check; writes and returns the run's result."""
    import convergence_torch as study

    install(variant)
    if not os.path.exists(os.path.join(workdir, "gt.json")):
        study.gen(workdir)
    epochs = math.ceil(steps / STUDY_STEPS_PER_EPOCH)
    config = study.make_config(workdir, epochs, train={"seed": seed})
    print(f"variant {variant}: bf16 in {parse_variant(variant) or 'none'}; "
          f"{epochs} epochs, seed {seed}", flush=True)
    rep = study.train(workdir, epochs, device=device, config=config)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else None
    rows = study.analyze(workdir, device=device)
    synth = study.synth(workdir, device=device)
    intervals = sorted(rep.step_s)
    result = {"variant": canonical(variant), "seed": seed, "steps": rep.state.step,
              "rows": rows, "synth": synth, "held": held(rows),
              "step_s_median": intervals[len(intervals) // 2] if intervals else None,
              "peak_gib": None if peak is None else peak / 2**30}
    os.makedirs(out or workdir, exist_ok=True)
    with open(os.path.join(out or workdir, f"{run_name(variant, seed)}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def run_name(variant: str, seed: int) -> str:
    return f"{canonical(variant)}@{seed}".replace(":", "-")


def tally(results: list[dict]) -> dict:
    """Per variant the runs and those held; Fisher's exact one-sided p of
    each bf16 variant holding more often than the package, and of f32
    holding more often than the package; the verdict (ROADMAP.md §3).
    ``results``: {"variant", "held"} each (held None: not counted)."""
    from scipy.stats import fisher_exact

    counts: dict[str, list[int]] = {}
    for r in results:
        if r["held"] is not None:
            n_h = counts.setdefault(canonical(r["variant"]), [0, 0])
            n_h[0] += 1
            n_h[1] += bool(r["held"])

    def p_more(a, b):
        (na, ha), (nb, hb) = counts[a], counts[b]
        return float(fisher_exact([[ha, na - ha], [hb, nb - hb]], alternative="greater")[1])

    out = {"counts": {v: {"runs": n, "held": h} for v, (n, h) in sorted(counts.items())},
           "p_over_package": {}, "p_f32_over_package": None}
    if PACKAGE not in counts:
        out["verdict"] = "inconclusive: no run of the package"
        return out
    for v in counts:
        if v not in (PACKAGE, F32_POLICY):
            out["p_over_package"][v] = p_more(v, PACKAGE)
    if F32_POLICY in counts:
        out["p_f32_over_package"] = p_more(F32_POLICY, PACKAGE)
    out["verdict"] = verdict(out)
    return out


def verdict(t: dict) -> str:
    """ROADMAP.md §3's rule, in its order: (a), (b), (c), else inconclusive."""
    fixes = sorted(v for v, p in t["p_over_package"].items() if p <= 0.05)
    if fixes:
        return "(a) fix found: " + ", ".join(fixes)
    p_f32 = t["p_f32_over_package"]
    if p_f32 is not None and p_f32 <= 0.05:
        return "(b) bf16 costs alignment on this card; no fix found"
    pkg = t["counts"][PACKAGE]
    if 3 * pkg["held"] >= pkg["runs"]:
        return "(c) not shown to be a port fault"
    return "inconclusive"


def prior_results(path: str = RUNS_JSON) -> list[dict]:
    """The runs in ``path`` whose label ends in ': <variant>@<seed>', each
    with ``held`` (None for a run that stopped before step 2400)."""
    with open(path) as f:
        runs = json.load(f)
    out = []
    for label, rows in runs.items():
        m = re.search(r": (\S+)@(\d+)$", label)
        if m:
            out.append({"label": label, "variant": canonical(m.group(1)),
                        "seed": int(m.group(2)), "held": held(rows)})
    return out


def load_results(out: str | None) -> list[dict]:
    if not out or not os.path.isdir(out):
        return []
    rs = []
    for name in sorted(os.listdir(out)):
        if name.endswith(".json") and "@" in name:
            with open(os.path.join(out, name)) as f:
                rs.append(json.load(f))
    return rs


def print_tally(out: str | None, card: str) -> dict:
    """Each run's row from ``out`` and the tally of those and the runs
    JSON's (written to ``out``/tally.json)."""
    new = load_results(out)
    for r in new:
        mae = {row["step"]: row["mas_boundary_mae"] for row in r["rows"]}
        acc = {row["step"]: row["mas_frame_acc"] for row in r["rows"]}
        print(f"{card} | run {r['variant']}@{r['seed']}: steps {r['steps']}, boundary MAE "
              + " / ".join(f"{mae.get(s, float('nan')):.2f}" for s in (1600, 2000, 2400))
              + f", held {r['held']}, frame acc {acc.get(2400, float('nan')):.3f}, held-out "
              f"{r['synth']['exact_order']}/{r['synth']['n']}, step median "
              f"{r['step_s_median'] or float('nan'):.3f} s, peak "
              f"{r['peak_gib'] or float('nan'):.2f} GiB")
    t = tally(new + prior_results())
    print(f"{card} | TALLY {json.dumps(t)}", flush=True)
    if out:
        with open(os.path.join(out, "tally.json"), "w") as f:
            json.dump(t, f, indent=1)
    return t


class _Run:
    def __init__(self, variant, seed, root):
        self.variant, self.seed = variant, seed
        self.name = run_name(variant, seed)
        self.workdir = os.path.join(root, self.name)
        self.proc = None
        self.started = None
        self.log = None

    def progress(self, since: float) -> tuple[int, float | None]:
        """(the last logged step, seconds a step over the logged steps after
        ``since``, None with fewer than two such lines)."""
        path = os.path.join(self.workdir, "run", "train.log")
        pts = []
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    m = re.match(r"(\S+ \S+)\t\S+\tINFO\tstep (\d+) \|", line)
                    if m:
                        t = time.mktime(time.strptime(m.group(1).split(",")[0],
                                                      "%Y-%m-%d %H:%M:%S"))
                        pts.append((t, int(m.group(2))))
        step = pts[-1][1] if pts else 0
        pts = [p for p in pts if p[0] >= since]
        if len(pts) < 2:
            return step, None
        (t0, s0), (t1, s1) = pts[max(0, len(pts) - 4)], pts[-1]
        return step, (t1 - t0) / (s1 - s0) if s1 > s0 else None

    def prune(self) -> None:
        """Keep the newest ``train_*`` checkpoint (resume), every ``eval_*``."""
        from vits_torch.training.checkpoint import _ckpt_steps

        model_dir = os.path.join(self.workdir, "run")
        for old in _ckpt_steps(model_dir, "train")[:-1]:
            try:
                os.remove(os.path.join(model_dir, f"train_{old}"))
            except FileNotFoundError:
                pass


def rates(runs: list[str], root: str, out: str, steps: int, card: str, jobs: int,
          deadline_s: float, device="cuda", max_jobs: int = MAX_JOBS,
          settle_s: float = 180.0, post_s: float = 150.0, startup_s: float = 90.0,
          poll_s: float = 20.0, worker=None) -> dict:
    """Run every ``variant@seed`` of ``runs`` (in this order of priority)
    side by side (the module docstring), then tally. ``worker(run)`` gives
    a run's command (default: this tool's ``train``)."""
    t_start = time.time()
    deadline = t_start + deadline_s
    os.makedirs(root, exist_ok=True)
    os.makedirs(out, exist_ok=True)
    queue = []
    for spec in runs:
        variant, _, seed = spec.rpartition("@")
        r = _Run(variant, int(seed), root)
        if os.path.exists(os.path.join(out, f"{r.name}.json")):
            print(f"{card} | rates: {r.name} done before, skipped")
        else:
            queue.append(r)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    running: list[_Run] = []
    event = time.time()

    def start(r):
        os.makedirs(r.workdir, exist_ok=True)
        r.log = open(os.path.join(r.workdir, "train.out"), "a")
        cmd = worker(r) if worker else [
            sys.executable, os.path.abspath(__file__), "train", "--workdir", r.workdir,
            "--variant", r.variant, "--seed", str(r.seed), "--steps", str(steps), "--out", out,
            "--device", device]
        r.proc = subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=r.log, stderr=subprocess.STDOUT, start_new_session=True)
        r.started = time.time()
        running.append(r)
        print(f"{card} | rates: +{time.time() - t_start:.0f} s start {r.name} "
              f"({len(running)} running)", flush=True)

    def stop(r, why):
        os.killpg(r.proc.pid, signal.SIGTERM)
        try:
            r.proc.wait(60)
        except subprocess.TimeoutExpired:
            os.killpg(r.proc.pid, signal.SIGKILL)
            r.proc.wait()
        running.remove(r)
        print(f"{card} | rates: +{time.time() - t_start:.0f} s stopped {r.name} at step "
              f"{r.progress(0)[0]}: {why}", flush=True)

    try:
        while queue and len(running) < min(jobs, max_jobs):
            start(queue.pop(0))
        while running or queue:
            now = time.time()
            if not running:  # all ended: one more alone, if it would finish in time
                if deadline - now < startup_s + steps * SOLO_STEP_S + post_s:
                    break
                start(queue.pop(0))
                event = time.time()
            time.sleep(poll_s)
            now = time.time()
            for r in list(running):
                r.prune()
                if r.proc.poll() is not None:
                    running.remove(r)
                    r.log.close()
                    print(f"{card} | rates: +{now - t_start:.0f} s {r.name} exited "
                          f"{r.proc.returncode} after {now - r.started:.0f} s", flush=True)
                    event = now
            if now > deadline:
                for r in list(running):
                    stop(r, "deadline")
                break
            est = {r: r.progress(event + 30) for r in running}
            if not running or now - event < settle_s or any(s is None for _, s in est.values()):
                continue
            k = len(running)
            if max(now + (steps - st) * s + post_s for st, s in est.values()) > deadline \
                    and k > 1:
                stop(max(running, key=lambda r: r.started), "would not finish by the deadline")
                event = time.time()
            elif queue and k < max_jobs:
                # the card's throughput shared by one more: each run slows by (k + 1) / k
                grow = (k + 1) / k
                s_new = grow * sum(s for _, s in est.values()) / k
                fits = all(now + (steps - st) * s * grow + post_s <= deadline
                           and s * grow <= MAX_STEP_S for st, s in est.values())
                if fits and now + startup_s + steps * s_new + post_s <= deadline \
                        and s_new <= MAX_STEP_S:
                    start(queue.pop(0))
                    event = time.time()
            print(f"{card} | rates: +{now - t_start:.0f} s " + ", ".join(
                f"{r.name} step {st} at {s:.2f} s" for r, (st, s) in est.items()), flush=True)
    finally:
        for r in list(running):
            stop(r, "the tool ended")
    left = [r.name for r in queue]
    if left:
        print(f"{card} | rates: not started: {', '.join(left)}")
    return print_tally(out, card)


def study_gaps(device: str, rows: int = 2, seed: int = 0) -> dict:
    """(1)(i): the gap table at the study's width with the flagship D, under
    the variant ``install`` set (the package's without one)."""
    import chip_smoke
    import convergence_torch as study
    from vits_torch.config import get_hparams
    from vits_torch.models import synthesizer
    from vits_torch.training import train as cli

    tmp = os.path.join(ROOT, "_chip_scratch", "gaps")
    os.makedirs(tmp, exist_ok=True)
    hps = get_hparams(study.make_config(tmp, 1), os.path.join(tmp, "run"))
    t_ys = [160, 120, 150, 100][:rows]
    batch, noise = chip_smoke.policy_batch(hps.model.inter_channels, hps.model.yin_channels,
                                           rows, 25, t_ys, seed)
    return chip_smoke.policy_gap_table(
        lambda bf16: synthesizer.build_synthesizer(hps, device="cpu", bf16=bf16),
        lambda bf16: cli.build_discriminator(hps, bf16, "cpu"),
        hps, batch, noise, seed, devices=("cpu",) if device == "cpu" else ("cpu", device))


def split_k_fault(k: int) -> None:
    """Make the port's bf16 convs on the card sum ``k`` split-K partials
    (slices of the input channels), each rounded to bf16, in bf16."""
    from vits_torch.models import modules

    plain = torch.nn.Conv1d._conv_forward
    conv_fwd = modules.Conv1d._conv_forward

    def conv_forward(self, x, weight, bias):
        cin = x.shape[1]
        if not x.is_cuda or x.dtype != torch.bfloat16 or self.groups != 1 or cin < 2 * k:
            return conv_fwd(self, x, weight, bias)
        w, y = weight.to(x.dtype), None
        for i in range(k):
            sl = slice(i * cin // k, (i + 1) * cin // k)
            part = plain(self, x[:, sl], w[:, sl], None)
            y = part if y is None else y + part
        return y if bias is None else y + bias.to(x.dtype)[:, None]

    modules.Conv1d._conv_forward = conv_forward


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=["gaps", "phase12", "train", "rates", "tally"])
    ap.add_argument("--workdir", default="conv_torch")
    ap.add_argument("--variant", default=PACKAGE)
    ap.add_argument("--steps", type=int, default=2400)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", type=int, default=0)
    ap.add_argument("--runs", default="", help="rates: variant@seed,... in order of priority")
    ap.add_argument("--root", default="_chip_scratch/rates", help="rates: the runs' workdirs")
    ap.add_argument("--out", default=None, help="train, rates, tally: the results' directory")
    ap.add_argument("--jobs", type=int, default=6, help="rates: runs started at once")
    ap.add_argument("--deadline-s", type=float, default=float("inf"),
                    help="rates: seconds by which every run must have finished")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import chip_smoke

    card = chip_smoke.card_line() if args.device != "cpu" else "cpu"
    if args.cmd == "train":
        train(args.workdir, args.variant, args.steps, args.seed, device=args.device,
              out=args.out)
        return 0
    if args.cmd == "tally":
        print_tally(args.out, card)
        return 0
    if args.cmd == "rates":
        rates([s for s in args.runs.split(",") if s], args.root,
              args.out or os.path.join(args.root, "results"),
              args.steps, card, args.jobs, args.deadline_s, device=args.device)
        return 0
    if args.cmd == "phase12":
        if args.fault:
            split_k_fault(args.fault)
        try:
            chip_smoke.check_bf16_card_against_cpu(card, 0)  # chip_smoke.py's seed
        except AssertionError as e:
            print(f"{card} | phase 12 failed (fault {args.fault}): {e}")
            return 1
        print(f"{card} | phase 12 passed (fault {args.fault})")
        return 0
    install(args.variant)
    table = study_gaps(args.device, args.rows)
    for (dev, prec), gaps in table.items():
        print(f"{card} | gaps ({args.variant}) {dev} {prec} vs cpu f32: " + ", ".join(
            f"{g}: forward {f:.3e} gradient {d:.3e}" for g, (f, d) in gaps.items()))
    print(json.dumps({f"{d} {p}": v for (d, p), v in table.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
