#!/usr/bin/env python3
"""Bisect the port's bf16 training policy: which group's bf16 compute, and
which rounding in it, makes the convergence study's MAS alignment drift.

The policy computes three groups in bfloat16 with f32 parameters: the
posterior encoders (``pe``), the HiFi-GAN decoder (``dec``) and the
discriminator (``disc``). A variant names the groups kept in bf16, joined by
``+`` (the others compute in f32), each with how it rounds after a colon:

  round        as the package computes (the default)
  wgrad32      as ``round``, but each conv's weight gradient leaves the conv
               in f32 (the bf16 products accumulated and written in f32),
               not rounded to bf16 before the cast to the f32 parameter
  f32between   each conv rounds its input and weight to bf16 and
               accumulates and writes its output in f32; every op between
               the convs (bias adds, gated units, residual and skip sums,
               leaky ReLUs, MRF averages, the PQMF banks) computes in f32,
               and the gradients are rounded only where a conv's input is
  fused        (``disc`` only) as XLA's fusions write the JAX
               discriminator: each conv writes its output in bf16 once;
               the bias add, the leaky ReLU and an MDC's branch sum after
               it compute in f32 and round to bf16 once, where the fusion
               writes a feature map, the logits or the next conv's input

e.g. ``pe``, ``dec+disc``, ``pe:wgrad32+dec:wgrad32+disc:wgrad32``,
``pe+dec+disc:f32between``, ``pe+dec+disc:fused``. The variants patch the
port's conv classes (and, for ``fused``, the discriminator's blocks) and the
train CLI's model builders in this process; the package itself has no
switch for them.

Subcommands (run from the repo root, on the card unless ``--device cpu``):

  gaps   one train step at the study's width (B=2, 160 and 120 frames) on
         the CPU and on the card from the same weights, batch, noise and
         PhaseAug draws, MAS on the CPU f32 step's path, TF32 off, cuDNN
         deterministic: the forward and gradient gap of each group under
         bf16 (card and CPU) and f32 (card) against the CPU's f32 step
  phase12  ``chip_smoke.py`` phase 12 alone, with its seed (card against CPU
         under bf16 at the tiny configuration); ``--fault K`` first makes the card's bf16
         convs (ungrouped, >= 2K input channels) sum K split-K partials
         that are each rounded to bf16, a fault a bf16 reduction would
         make, to show the phase's tolerance catches it
  train  ``tools/convergence_torch.py``'s study training under a variant:
         --workdir W --variant V --steps N --seed S; ``gen`` first if W has
         no corpus; then run that tool's ``analyze`` and ``synth`` on W

Every line the card prints carries its name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = ("pe", "dec", "disc")
MODES = ("round", "wgrad32", "f32between", "fused")
STUDY_STEPS_PER_EPOCH = 17  # 256 training utterances in B=16 buckets


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
        if mode == "fused" and group != "disc":
            raise SystemExit(f"variant {name!r}: 'fused' applies to disc only")
        kept[group] = mode or "round"
    return kept


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
        # the conv's output rounded once, as the conv writes it; the bias
        # (and what the caller fuses after it) in f32
        y = torch.ops.aten.convolution(x, weight.to(x.dtype), None, *_conv_params(conv)).float()
        return y if bias is None else y + bias[:, None]
    return plain()


def patch_discriminator() -> None:
    """Make the discriminator's blocks round each fusion's output once:
    under ``fused`` a conv returns its f32 epilogue, and these forwards add
    the activation (and an MDC's branch sum) in f32 and round to the
    block's input dtype. Unmarked convs return their input's dtype, for
    which these forwards compute as the package's."""
    from torch.nn import functional as F

    from vits_torch.models import avocodo

    lrelu = avocodo.LRELU

    def combd_forward(self, x, b_y, b_y_hat):
        fmap_r, fmap_g = [], []
        tile = b_y < b_y_hat
        dt = x.dtype
        for conv in self.convs:
            x = F.leaky_relu(conv(x), lrelu).to(dt)
            f_r, f_g = x[:b_y], x[b_y:]
            fmap_r.append(f_r.repeat(2, 1, 1) if tile else f_r)
            fmap_g.append(f_g)
        x = self.projection_conv(x).to(dt)
        x_r, x_g = x[:b_y], x[b_y:]
        return (x_r.repeat(2, 1, 1) if tile else x_r), x_g, fmap_r, fmap_g

    def mdc_forward(self, x):
        out = None
        for conv in self.d_convs:  # the branches and their sum: one fusion
            y = F.leaky_relu(conv(x), lrelu)
            out = y if out is None else out + y
        return F.leaky_relu(self.post_conv(out.to(x.dtype)), lrelu).to(x.dtype)

    def sbd_forward(self, x):
        fmap_r, fmap_g = [], []
        half = x.shape[0] // 2
        for conv in self.convs:
            x = conv(x)
            fmap_r.append(x[:half])
            fmap_g.append(x[half:])
        x = self.post_conv(x).to(x.dtype)
        return x[:half], x[half:], fmap_r, fmap_g

    avocodo.CoMBDBlock.forward = combd_forward
    avocodo.MDC.forward = mdc_forward
    avocodo.SBDBlock.forward = sbd_forward


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
    """Set the bf16 flag and the convs' marks of each group in ``parts``
    ({group: [modules]}) under the bf16 policy."""
    from vits_torch.models.modules import Conv1d, ConvTranspose1d

    for group, mods in parts.items():
        mode = kept.get(group)
        for m in mods:
            m.bf16 = mode is not None and mode != "f32between"
            for c in m.modules():
                if isinstance(c, (Conv1d, ConvTranspose1d)):
                    c._ablation = mode if mode not in (None, "round") else None


def model_parts(model) -> dict:
    return {"pe": [model.posterior_encoder, model.pitch_encoder],
            "dec": [model.waveform_decoder]}


def patch_builders(kept: dict) -> None:
    """Make the train CLI build its generator and discriminator under the
    variant (when the config asks for the bf16 policy)."""
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

    cli.build_synthesizer, cli.build_discriminator = build_synthesizer, build_discriminator


def train(workdir: str, variant: str, steps: int, seed: int, device=None):
    """The study's training under ``variant`` for at least ``steps`` steps
    (whole epochs), ``train.seed`` = ``seed``."""
    import convergence_torch as study

    kept = parse_variant(variant)
    patch_convs()
    if kept.get("disc") == "fused":
        patch_discriminator()
    patch_builders(kept)
    if not os.path.exists(os.path.join(workdir, "gt.json")):
        study.gen(workdir)
    epochs = math.ceil(steps / STUDY_STEPS_PER_EPOCH)
    config = study.make_config(workdir, epochs, train={"seed": seed})
    print(f"variant {variant}: bf16 in {kept or 'none'}; "
          f"{epochs} epochs, seed {seed}", flush=True)
    return study.train(workdir, epochs, device=device, config=config)


def study_gaps(device: str, rows: int = 2, seed: int = 0) -> dict:
    """(1)(i): the gap table at the study's width with the flagship D."""
    import chip_smoke
    import convergence_torch as study
    from vits_torch.config import get_hparams
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.training.train import build_discriminator

    tmp = os.path.join(ROOT, "_chip_scratch", "gaps")
    os.makedirs(tmp, exist_ok=True)
    hps = get_hparams(study.make_config(tmp, 1), os.path.join(tmp, "run"))
    t_ys = [160, 120, 150, 100][:rows]
    batch, noise = chip_smoke.policy_batch(hps.model.inter_channels, hps.model.yin_channels,
                                           rows, 25, t_ys, seed)
    return chip_smoke.policy_gap_table(
        lambda bf16: build_synthesizer(hps, device="cpu", bf16=bf16),
        lambda bf16: build_discriminator(hps, bf16, "cpu"),
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
    ap.add_argument("cmd", choices=["gaps", "phase12", "train"])
    ap.add_argument("--workdir", default="conv_torch")
    ap.add_argument("--variant", default="pe+dec+disc")
    ap.add_argument("--steps", type=int, default=2400)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import chip_smoke

    card = chip_smoke.card_line() if args.device != "cpu" else "cpu"
    if args.cmd == "train":
        train(args.workdir, args.variant, args.steps, args.seed, device=args.device)
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
    table = study_gaps(args.device, args.rows)
    for (dev, prec), gaps in table.items():
        print(f"{card} | gaps {dev} {prec} vs cpu f32: " + ", ".join(
            f"{g}: forward {f:.3e} gradient {d:.3e}" for g, (f, d) in gaps.items()))
    print(json.dumps({f"{d} {p}": v for (d, p), v in table.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
