"""Avocodo discriminators: CoMBD (collaborative multi-band) and SBD
(sub-band) (port of ``vits_tpu/models/avocodo.py``).

Real and generated audio run concatenated along the batch axis through each
block and are split afterwards; where the generated batch is larger (CoMBD's
multi-scale inputs), the real logits and feature maps are tiled 2x to align.
Module and parameter names are the torch reference's
(``combd.blocks.{i}.convs.{j}``, ``combd.blocks.{i}.projection_conv``,
``sbd.discriminators.{i}.convs.{j}.d_convs.{k}``, ``....post_conv``), so
``vits_tpu/utils/convert_torch.py::convert_discriminator`` reads a port
state dict directly.

Public layout as in the JAX package: audio ``[B, T, 1]``; logits and
feature maps come back ``[B, T', C]`` (views of the NCL tensors the convs
compute). ``bf16=True`` casts the audio to bfloat16 at entry: the PQMF banks
and every conv then compute in bfloat16 and the losses cast back to f32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from vits_torch.models.modules import conv1d
from vits_torch.models.synthesizer import resolve_device
from vits_torch.ops.pqmf import PQMF

LRELU = 0.2


def _get_padding(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


def _wn(in_ch, out_ch, k, **kw):
    return conv1d(in_ch, out_ch, k, use_weight_norm=True, **kw)


def _cl(x: torch.Tensor) -> torch.Tensor:
    """NCL -> the JAX layout [B, T, C] (a view)."""
    return x.transpose(1, 2)


class CoMBDBlock(nn.Module):
    """Stacked grouped strided convs + projection. ``dense_grouped`` is the
    JAX package's TPU layout knob (a grouped conv lowered as one
    block-diagonal dense conv, parameters unchanged); it is accepted and the
    same grouped conv is computed either way."""

    def __init__(self, h_u, d_k, d_s, d_d, d_g, d_p, op_f, op_k, op_g, dense_grouped=False):
        super().__init__()
        del dense_grouped
        self.convs = nn.ModuleList()
        in_ch = 1
        for f, k, s, d, g, p in zip(h_u, d_k, d_s, d_d, d_g, d_p):
            self.convs.append(_wn(in_ch, f, k, stride=s, dilation=d, groups=g, padding=p))
            in_ch = f
        self.projection_conv = _wn(in_ch, op_f, op_k, groups=op_g)

    def forward(self, x, b_y: int, b_y_hat: int):
        """x: [b_y + b_y_hat, 1, T] NCL -> (x_r, x_g, fmap_r, fmap_g), NCL."""
        fmap_r, fmap_g = [], []
        tile = b_y < b_y_hat
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU)
            f_r, f_g = x[:b_y], x[b_y:]
            fmap_r.append(f_r.repeat(2, 1, 1) if tile else f_r)
            fmap_g.append(f_g)
        x = self.projection_conv(x)
        x_r, x_g = x[:b_y], x[b_y:]
        return (x_r.repeat(2, 1, 1) if tile else x_r), x_g, fmap_r, fmap_g


@dataclasses.dataclass(frozen=True)
class CoMBDConfig:
    """CoMBD dimensions; defaults are the reference's flagship values."""

    h_u: tuple = (16, 64, 256, 1024, 1024, 1024)
    d_k: tuple = (
        (7, 11, 11, 11, 11, 5),
        (11, 21, 21, 21, 21, 5),
        (15, 41, 41, 41, 41, 5),
    )
    d_s: tuple = (1, 1, 4, 4, 4, 1)
    d_d: tuple = (1, 1, 1, 1, 1, 1)
    d_g: tuple = (1, 4, 16, 64, 256, 1)
    d_p: tuple = (
        (3, 5, 5, 5, 5, 2),
        (5, 10, 10, 10, 10, 2),
        (7, 20, 20, 20, 20, 2),
    )
    op_f: int = 1
    op_k: int = 3
    op_g: int = 1
    pqmf_lv2: tuple = (4, 192, 0.13, 10.0)
    pqmf_lv1: tuple = (2, 256, 0.25, 10.0)
    dense_grouped: bool = False


COMBD_FLAGSHIP = CoMBDConfig()
# 2-layer blocks of 8 and 16 channels: the same structure (3 scales, strided
# convs, projection) at a size for tests and probes
COMBD_PROBE = CoMBDConfig(
    h_u=(8, 16),
    d_k=((7, 5), (11, 5), (15, 5)),
    d_s=(4, 1),
    d_d=(1, 1),
    d_g=(1, 1),
    d_p=((3, 2), (5, 2), (7, 2)),
)


class CoMBD(nn.Module):
    """Three blocks over the hierarchical scales, with PQMF projections of
    the final generated output as extra generated inputs."""

    def __init__(self, cfg: CoMBDConfig = COMBD_FLAGSHIP):
        super().__init__()
        self.pqmf_lv2 = PQMF(*cfg.pqmf_lv2)
        self.pqmf_lv1 = PQMF(*cfg.pqmf_lv1)
        self.blocks = nn.ModuleList(
            CoMBDBlock(cfg.h_u, cfg.d_k[i], cfg.d_s, cfg.d_d, cfg.d_g, cfg.d_p[i],
                       cfg.op_f, cfg.op_k, cfg.op_g, cfg.dense_grouped)
            for i in range(len(cfg.d_k))
        )

    def forward(self, ys, ys_hat):
        """ys, ys_hat: 3 x [B, T_i, 1] (the generated ones may have 2B rows)."""
        multi_scale_hat = [
            self.pqmf_lv2.analysis(ys_hat[-1])[..., :1],
            self.pqmf_lv1.analysis(ys_hat[-1])[..., :1],
        ]
        inputs_fake = [
            torch.cat([y_hat, multi_scale_hat[i]], dim=0) if i != len(ys_hat) - 1 else y_hat
            for i, y_hat in enumerate(ys_hat)
        ]
        outs_real, outs_fake, fmaps_real, fmaps_fake = [], [], [], []
        for y, y_hat, block in zip(ys, inputs_fake, self.blocks):
            b_y, b_y_hat = y.shape[0], y_hat.shape[0]
            cat_y = _cl(torch.cat([y, y_hat], dim=0))  # [b_y + b_y_hat, 1, T]
            o_r, o_g, f_r, f_g = block(cat_y, b_y, b_y_hat)
            outs_real.append(_cl(o_r))
            outs_fake.append(_cl(o_g))
            fmaps_real.append([_cl(f) for f in f_r])
            fmaps_fake.append([_cl(f) for f in f_g])
        return outs_real, outs_fake, fmaps_real, fmaps_fake


class MDC(nn.Module):
    """Multi-dilated conv: the sum of the dilation branches, then a strided
    kernel-3 post conv whose padding follows the last branch's kernel and
    dilation (a reference quirk, kept)."""

    def __init__(self, in_channels, out_channels, strides, kernel_size, dilations):
        super().__init__()
        self.d_convs = nn.ModuleList(
            _wn(in_channels, out_channels, k, dilation=d, padding=_get_padding(k, d))
            for k, d in zip(kernel_size, dilations)
        )
        self.post_conv = _wn(
            out_channels, out_channels, 3, stride=strides,
            padding=_get_padding(kernel_size[-1], dilations[-1]),
        )

    def forward(self, x):
        out = None
        for conv in self.d_convs:
            y = F.leaky_relu(conv(x), LRELU)
            out = y if out is None else out + y
        return F.leaky_relu(self.post_conv(out), LRELU)


class SBDBlock(nn.Module):
    """A stack of MDCs and a 1-channel post conv; real and generated halves
    of the batch split after each layer."""

    def __init__(self, in_channels, filters, strides, kernel_sizes, dilations):
        super().__init__()
        self.convs = nn.ModuleList()
        for f, s, k, d in zip(filters, strides, kernel_sizes, dilations):
            self.convs.append(MDC(in_channels, f, s, k, d))
            in_channels = f
        self.post_conv = _wn(in_channels, 1, 3, padding=1)

    def forward(self, x):
        """x: [2B, C, T] NCL -> (x_r, x_g, fmap_r, fmap_g), NCL."""
        fmap_r, fmap_g = [], []
        half = x.shape[0] // 2
        for conv in self.convs:
            x = conv(x)
            fmap_r.append(x[:half])
            fmap_g.append(x[half:])
        x = self.post_conv(x)
        return x[:half], x[half:], fmap_r, fmap_g


@dataclasses.dataclass(frozen=True)
class SBDConfig:
    """SBD dimensions; defaults are the reference's flagship values.
    ``segment_size`` sets the input channels of the transposed (frequency)
    band, segment_size / f_pqmf subbands."""

    pqmf_params: tuple = (16, 256, 0.03, 10.0)
    f_pqmf_params: tuple = (64, 256, 0.1, 9.0)
    filters: tuple = (
        (64, 128, 256, 256, 256),
        (64, 128, 256, 256, 256),
        (64, 128, 256, 256, 256),
        (32, 64, 128, 128, 128),
    )
    kernel_sizes: tuple = (
        ((7, 7, 7),) * 5,
        ((5, 5, 5),) * 5,
        ((3, 3, 3),) * 5,
        ((5, 5, 5),) * 5,
    )
    dilations: tuple = (
        ((5, 7, 11),) * 5,
        ((3, 5, 7),) * 5,
        ((1, 2, 3),) * 5,
        ((1, 2, 3), (1, 2, 3), (1, 2, 3), (2, 3, 5), (2, 3, 5)),
    )
    strides: tuple = ((1, 1, 3, 3, 1),) * 4
    band_ranges: tuple = ((0, 6), (0, 11), (0, 16), (0, 64))
    transpose: tuple = (False, False, False, True)
    segment_size: int = 8192


SBD_FLAGSHIP = SBDConfig()
# the same 4-band structure (3 time-band discriminators and 1 transposed
# frequency one), 2 MDC layers of 8 channels with one dilation branch each
SBD_PROBE = SBDConfig(
    filters=((8, 8),) * 4,
    kernel_sizes=(((3,), (3,)),) * 4,
    dilations=(((1,), (1,)),) * 4,
    strides=((1, 3),) * 4,
)


class SBD(nn.Module):
    """Sub-band discriminator over PQMF time bands and transposed
    frequency bands (the frequency bands become the time axis)."""

    def __init__(self, cfg: SBDConfig = SBD_FLAGSHIP):
        super().__init__()
        self.cfg = cfg
        self.pqmf = PQMF(*cfg.pqmf_params)
        self.f_pqmf = PQMF(*cfg.f_pqmf_params)
        self.discriminators = nn.ModuleList()
        for f, k, d, s, br, tr in zip(cfg.filters, cfg.kernel_sizes, cfg.dilations,
                                      cfg.strides, cfg.band_ranges, cfg.transpose):
            in_ch = cfg.segment_size // cfg.f_pqmf_params[0] if tr else br[1] - br[0]
            self.discriminators.append(SBDBlock(in_ch, f, s, k, d))

    def forward(self, y, y_hat):
        """y, y_hat: [B, T, 1] -> lists of logits and feature maps."""
        cfg = self.cfg
        y_in = _cl(self.pqmf.analysis(torch.cat([y, y_hat], dim=0)))  # [2B, 16, T/16]
        y_in_f = self.f_pqmf.analysis(torch.cat([y, y_hat], dim=0))  # [2B, T/64, 64]
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d, br, tr in zip(self.discriminators, cfg.band_ranges, cfg.transpose):
            # transposed: the 64 bands become the time axis, frames the channels
            x = y_in_f[..., br[0] : br[1]] if tr else y_in[:, br[0] : br[1]]
            y_d_r, y_d_g, fmap_r, fmap_g = d(x)
            y_d_rs.append(_cl(y_d_r))
            y_d_gs.append(_cl(y_d_g))
            fmap_rs.append([_cl(f) for f in fmap_r])
            fmap_gs.append([_cl(f) for f in fmap_g])
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class AvocodoDiscriminator(nn.Module):
    """CoMBD + SBD. y: real audio [B, T, 1]; ys_hat: 3 generated outputs
    [(2)B, T/4, 1], [(2)B, T/2, 1], [(2)B, T, 1]. Returns (real logits,
    generated logits, real feature maps, generated feature maps), CoMBD's
    three then SBD's four. ``segment_size`` (T) replaces ``sbd_cfg``'s: it
    sets the transposed band's input channels."""

    def __init__(self, combd_cfg: CoMBDConfig = COMBD_FLAGSHIP,
                 sbd_cfg: SBDConfig = SBD_FLAGSHIP, bf16: bool = False,
                 segment_size: int | None = None, device=None):
        super().__init__()
        self.bf16 = bf16
        if segment_size is not None:
            sbd_cfg = dataclasses.replace(sbd_cfg, segment_size=segment_size)
        self.combd = CoMBD(combd_cfg)
        self.sbd = SBD(sbd_cfg)
        self.to(resolve_device(device))

    def forward(self, y, ys_hat):
        if self.bf16:
            y = y.to(torch.bfloat16)
            ys_hat = [o.to(torch.bfloat16) for o in ys_hat]
        ys = [
            self.combd.pqmf_lv2.analysis(y)[..., :1],
            self.combd.pqmf_lv1.analysis(y)[..., :1],
            y,
        ]
        y_c_rs, y_c_gs, fmap_c_rs, fmap_c_gs = self.combd(ys, ys_hat)
        y_s_rs, y_s_gs, fmap_s_rs, fmap_s_gs = self.sbd(y, ys_hat[-1])
        return y_c_rs + y_s_rs, y_c_gs + y_s_gs, fmap_c_rs + fmap_s_rs, fmap_c_gs + fmap_s_gs


def probe_discriminator(**kwargs) -> AvocodoDiscriminator:
    """The structurally complete, minimally sized discriminator of tests and
    probes."""
    return AvocodoDiscriminator(combd_cfg=COMBD_PROBE, sbd_cfg=SBD_PROBE, **kwargs)
