"""Load vits_tpu (flax) parameters into the port's modules.

The exact inverse of ``vits_tpu/utils/convert_torch.py``: the port keeps the
torch reference's state-dict names, so a flax ``{'params': ...}`` tree (numpy
arrays) maps back onto ``state_dict()`` keys with only layout changes:

  flax Conv1d kernel [k, in, out]          -> torch weight [out, in, k]
  flax ConvTranspose1d kernel [k, in, out] -> torch weight [in, out, k]
  (kernel, g)                              -> (weight_v, weight_g [C, 1, 1])
  nn.Embed embedding                       -> nn.Embedding weight
  flax LayerNorm (scale, bias)             -> (gamma, beta)

The discriminator (``models/avocodo.py``) maps the same way, the inverse of
``convert_discriminator``: ``combd/block_{i}/conv_{j}`` ->
``combd.blocks.{i}.convs.{j}``, ``projection`` -> ``projection_conv``,
``sbd/disc_{i}/mdc_{j}/dconv_{k}`` ->
``sbd.discriminators.{i}.convs.{j}.d_convs.{k}``, ``post`` -> ``post_conv``.

Depths (layers, flows, resblocks) are read off the port module, so one call
works for any configuration. ``load_flax_params`` loads strictly: a key the
tree does not fill, or a shape that differs, raises.
"""

from __future__ import annotations

import numpy as np
import torch

from vits_torch.models.attention import MultiHeadAttention
from vits_torch.models.avocodo import MDC, AvocodoDiscriminator, CoMBDBlock, SBDBlock
from vits_torch.models.duration import StochasticDurationPredictor
from vits_torch.models.flows import (
    ConvFlow,
    ElementwiseAffine,
    ResidualCouplingBlock,
    ResidualCouplingLayer,
)
from vits_torch.models.hifigan import HiFiGANGenerator, ResBlock1
from vits_torch.models.modules import DDSConv, WaveNet
from vits_torch.models.posterior_encoder import PosteriorEncoder
from vits_torch.models.synthesizer import SynthesizerTrn
from vits_torch.models.text_encoder import TextEncoder
from vits_torch.models.ying_decoder import YingDecoder


def _conv(sd, prefix, p, weight_norm=False, transpose=False):
    kernel = np.asarray(p["kernel"])
    w = kernel.transpose(1, 2, 0) if transpose else kernel.transpose(2, 1, 0)
    if weight_norm:
        sd[f"{prefix}.weight_v"] = w
        sd[f"{prefix}.weight_g"] = np.asarray(p["g"]).reshape(-1, 1, 1)
    else:
        sd[f"{prefix}.weight"] = w
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _layernorm(sd, prefix, p):
    sd[f"{prefix}.gamma"] = np.asarray(p["scale"])
    sd[f"{prefix}.beta"] = np.asarray(p["bias"])


def _wavenet(sd, prefix, p, m: WaveNet):
    if "cond_layer" in p:
        _conv(sd, f"{prefix}.cond_layer", p["cond_layer"], weight_norm=True)
    for i in range(m.n_layers):
        _conv(sd, f"{prefix}.in_layers.{i}", p[f"in_{i}"], weight_norm=True)
        _conv(sd, f"{prefix}.res_skip_layers.{i}", p[f"res_skip_{i}"], weight_norm=True)


def _ddsconv(sd, prefix, p, m: DDSConv):
    for i in range(m.n_layers):
        _conv(sd, f"{prefix}.convs_sep.{i}", p[f"sep_{i}"])
        _conv(sd, f"{prefix}.convs_1x1.{i}", p[f"pointwise_{i}"])
        _layernorm(sd, f"{prefix}.norms_1.{i}", p[f"norm1_{i}"])
        _layernorm(sd, f"{prefix}.norms_2.{i}", p[f"norm2_{i}"])


def _posterior_encoder(sd, prefix, p, m: PosteriorEncoder):
    _conv(sd, f"{prefix}.pre", p["pre"])
    _wavenet(sd, f"{prefix}.enc", p["enc"], m.enc)
    _conv(sd, f"{prefix}.proj", p["proj"])


def _coupling_layer(sd, prefix, p, m: ResidualCouplingLayer):
    _conv(sd, f"{prefix}.pre", p["pre"])
    _wavenet(sd, f"{prefix}.enc", p["enc"], m.enc)
    _conv(sd, f"{prefix}.post", p["post"])


def _coupling_block(sd, prefix, p, m: ResidualCouplingBlock):
    for i in range(len(m.flows) // 2):
        _coupling_layer(sd, f"{prefix}.flows.{2 * i}", p[f"coupling_{i}"], m.flows[2 * i])


def _elementwise_affine(sd, prefix, p, m=None):
    sd[f"{prefix}.m"] = np.asarray(p["m"]).reshape(-1, 1)
    sd[f"{prefix}.logs"] = np.asarray(p["logs"]).reshape(-1, 1)


def _conv_flow(sd, prefix, p, m: ConvFlow):
    _conv(sd, f"{prefix}.pre", p["pre"])
    _ddsconv(sd, f"{prefix}.convs", p["convs"], m.convs)
    _conv(sd, f"{prefix}.proj", p["proj"])


def _sdp(sd, prefix, p, m: StochasticDurationPredictor):
    for name in ("pre", "proj", "post_pre", "post_proj", "cond"):
        if name in p:
            _conv(sd, f"{prefix}.{name}", p[name])
    _ddsconv(sd, f"{prefix}.convs", p["convs"], m.convs)
    _ddsconv(sd, f"{prefix}.post_convs", p["post_convs"], m.post_convs)
    _elementwise_affine(sd, f"{prefix}.flows.0", p["flow_pre"])
    _elementwise_affine(sd, f"{prefix}.post_flows.0", p["post_flow_pre"])
    for i in range((len(m.flows) - 1) // 2):
        _conv_flow(sd, f"{prefix}.flows.{1 + 2 * i}", p[f"flow_{i}"], m.flows[1 + 2 * i])
    for i in range((len(m.post_flows) - 1) // 2):
        _conv_flow(
            sd, f"{prefix}.post_flows.{1 + 2 * i}", p[f"post_flow_{i}"],
            m.post_flows[1 + 2 * i],
        )


def _attention(sd, prefix, p, m: MultiHeadAttention):
    for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
        _conv(sd, f"{prefix}.{name}", p[name])
    for name in ("emb_rel_k", "emb_rel_v"):
        if name in p:
            sd[f"{prefix}.{name}"] = np.asarray(p[name])


def _text_encoder(sd, prefix, p, m: TextEncoder):
    sd[f"{prefix}.emb.weight"] = np.asarray(p["emb"]["embedding"])
    sd[f"{prefix}.emb_t.weight"] = np.asarray(p["emb_t"]["embedding"])
    enc, e = p["encoder"], f"{prefix}.encoder"
    for i in range(m.encoder.n_layers):
        _attention(sd, f"{e}.attn_layers.{i}", enc[f"attn_{i}"], m.encoder.attn_layers[i])
        _layernorm(sd, f"{e}.norm_layers_1.{i}", enc[f"norm1_{i}"])
        _conv(sd, f"{e}.ffn_layers.{i}.conv_1", enc[f"ffn_{i}"]["conv_1"])
        _conv(sd, f"{e}.ffn_layers.{i}.conv_2", enc[f"ffn_{i}"]["conv_2"])
        _layernorm(sd, f"{e}.norm_layers_2.{i}", enc[f"norm2_{i}"])
    _conv(sd, f"{prefix}.proj", p["proj"])


def _hifigan(sd, prefix, p, m: HiFiGANGenerator):
    _conv(sd, f"{prefix}.conv_pre", p["conv_pre"])
    if "cond" in p:
        _conv(sd, f"{prefix}.cond", p["cond"])
    nk = m.num_kernels
    for i in range(m.num_upsamples):
        _conv(sd, f"{prefix}.ups.{i}", p[f"up_{i}"], weight_norm=True, transpose=True)
        for j in range(nk):
            rb, rp = m.resblocks[i * nk + j], p[f"resblock_{i}_{j}"]
            r = f"{prefix}.resblocks.{i * nk + j}"
            if isinstance(rb, ResBlock1):
                for k in range(len(rb.convs1)):
                    _conv(sd, f"{r}.convs1.{k}", rp[f"conv1_{k}"], weight_norm=True)
                    _conv(sd, f"{r}.convs2.{k}", rp[f"conv2_{k}"], weight_norm=True)
            else:
                for k in range(len(rb.convs)):
                    _conv(sd, f"{r}.convs.{k}", rp[f"conv_{k}"], weight_norm=True)
    for i in range(3):
        _conv(sd, f"{prefix}.conv_posts.{i}", p[f"conv_post_{i}"])


def _ying_decoder(sd, prefix, p, m: YingDecoder):
    _conv(sd, f"{prefix}.pre", p["pre"])
    _wavenet(sd, f"{prefix}.dec", p["dec"], m.dec)
    _conv(sd, f"{prefix}.proj", p["proj"])


def _synthesizer(sd, prefix, p, m: SynthesizerTrn):
    for name, conv in (
        ("text_encoder", _text_encoder),
        ("posterior_encoder", _posterior_encoder),
        ("pitch_encoder", _posterior_encoder),
        ("flow", _coupling_block),
        ("duration_predictor", _sdp),
        ("waveform_decoder", _hifigan),
        ("yin_decoder", _ying_decoder),
    ):
        conv(sd, f"{prefix}.{name}", p[name], getattr(m, name))
    if "emb_g" in p:
        sd[f"{prefix}.emb_g.weight"] = np.asarray(p["emb_g"]["embedding"])


def _combd_block(sd, prefix, p, m: CoMBDBlock):
    for i in range(len(m.convs)):
        _conv(sd, f"{prefix}.convs.{i}", p[f"conv_{i}"], weight_norm=True)
    _conv(sd, f"{prefix}.projection_conv", p["projection"], weight_norm=True)


def _mdc(sd, prefix, p, m: MDC):
    for i in range(len(m.d_convs)):
        _conv(sd, f"{prefix}.d_convs.{i}", p[f"dconv_{i}"], weight_norm=True)
    _conv(sd, f"{prefix}.post_conv", p["post"], weight_norm=True)


def _sbd_block(sd, prefix, p, m: SBDBlock):
    for i, mdc in enumerate(m.convs):
        _mdc(sd, f"{prefix}.convs.{i}", p[f"mdc_{i}"], mdc)
    _conv(sd, f"{prefix}.post_conv", p["post"], weight_norm=True)


def _discriminator(sd, prefix, p, m: AvocodoDiscriminator):
    for i, block in enumerate(m.combd.blocks):
        _combd_block(sd, f"{prefix}.combd.blocks.{i}", p["combd"][f"block_{i}"], block)
    for i, disc in enumerate(m.sbd.discriminators):
        _sbd_block(sd, f"{prefix}.sbd.discriminators.{i}", p["sbd"][f"disc_{i}"], disc)


_CONVERTERS = {
    WaveNet: _wavenet,
    DDSConv: _ddsconv,
    PosteriorEncoder: _posterior_encoder,
    ResidualCouplingBlock: _coupling_block,
    ElementwiseAffine: _elementwise_affine,
    ConvFlow: _conv_flow,
    StochasticDurationPredictor: _sdp,
    MultiHeadAttention: _attention,
    TextEncoder: _text_encoder,
    HiFiGANGenerator: _hifigan,
    YingDecoder: _ying_decoder,
    SynthesizerTrn: _synthesizer,
    CoMBDBlock: _combd_block,
    MDC: _mdc,
    SBDBlock: _sbd_block,
    AvocodoDiscriminator: _discriminator,
}


def flax_to_state_dict(model: torch.nn.Module, variables) -> dict[str, np.ndarray]:
    """flax ``{'params': ...}`` (or the bare params tree) -> the port
    module's state-dict entries as numpy arrays."""
    params = variables.get("params", variables)
    sd: dict[str, np.ndarray] = {}
    # the converters write "<prefix>.<name>"; a bare module has no prefix
    _CONVERTERS[type(model)](sd, "_", params, model)
    return {k.removeprefix("_."): v for k, v in sd.items()}


def load_flax_params(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load a flax parameter tree into ``model`` in place (strict)."""
    sd = flax_to_state_dict(model, variables)
    dev = next(model.parameters()).device
    model.load_state_dict(
        {k: torch.as_tensor(np.array(v, dtype=np.float32), device=dev) for k, v in sd.items()},
        strict=True,
    )
    return model
