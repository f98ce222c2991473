"""Migrate reference (Aloento/VITS) checkpoints into the port's format: the
counterpart of the file-level half of ``vits_tpu/utils/convert_torch.py``
(``_detect_arch``, ``convert_checkpoint_file``, ``main``; the
``vits-tpu-convert`` script). Named apart from it because the port's
``utils/convert_jax.py`` already holds the other direction (flax tree ->
port modules).

The port keeps the reference's state-dict names, so the mapping is the
identity on names. What it reproduces is *which* entries are taken: the
walk below reads exactly the keys the JAX converter reads
(``convert_synthesizer``, ``convert_discriminator``: the same prefixes and
the same fixed depths, 16 posterior layers, 4 flows, 4 SDP flows, 4
Yin-decoder layers, 3 CoMBD blocks of 6 convs, 4 SBD discriminators of 5
MDCs). A key it reads and the payload lacks raises ``KeyError``, as the JAX
converter's ``sd[...]`` does; every other entry of the payload (the
reference discriminator's PQMF filter buffers, anything outside the walk)
is dropped, as the JAX converter never reads it, and the port's strict
loads would refuse it.

    python -m vits_torch.utils.convert_reference Model_Eval_200000.pth \\
        --out-dir runs/migrated [--train-pth Model_Train_200000.pth]

writes ``runs/migrated/eval_200000`` (``{"g_params": ...}``, which
``TTSEngine`` and ``load_eval_params`` read) and, with ``--train-pth``,
``disc_200000`` (``{"d_params": ...}``, for GAN fine-tuning through
``training.checkpoint.merge_compatible``). The reference's optimizer moments
are not carried over. Reference format: reference utils.py:91-116
(``{'model_g': ...}`` / ``{'model_d': ...}``).
"""

from __future__ import annotations

import logging
import os
import re

import torch

from vits_torch.training.checkpoint import _save

log = logging.getLogger(__name__)


def _strip_module(sd: dict) -> dict:
    """The first ``module.`` of each key removed, wherever it stands, as
    the JAX converter does (a reference trained under DDP saves
    ``module.``-prefixed keys)."""
    return {k.replace("module.", "", 1): v for k, v in sd.items()}


def _detect_arch(sd: dict) -> dict:
    """Architecture hyperparameters read off the state-dict key structure,
    so conversion needs no hand-supplied flags."""

    def _count(pattern):
        idx = {int(m.group(1)) for k in sd for m in [re.match(pattern, k)] if m}
        return (max(idx) + 1) if idx else 0

    n_layers_text = _count(r"text_encoder\.encoder\.attn_layers\.(\d+)\.")
    n_ups = _count(r"waveform_decoder\.ups\.(\d+)\.")
    n_resblocks = _count(r"waveform_decoder\.resblocks\.(\d+)\.")
    resblock_convs = _count(r"waveform_decoder\.resblocks\.0\.convs1\.(\d+)\.")
    return dict(
        n_layers_text=n_layers_text,
        n_ups=n_ups,
        n_kernels=n_resblocks // max(n_ups, 1),
        resblock_convs=resblock_convs,
    )


# ---- the keys the JAX converter reads, walked as it walks them ------------


def _conv(sd, keys, prefix, weight_norm=False, bias=True):
    keys += [f"{prefix}.weight_v", f"{prefix}.weight_g"] if weight_norm else [f"{prefix}.weight"]
    if bias and f"{prefix}.bias" in sd:
        keys.append(f"{prefix}.bias")


def _layernorm(sd, keys, prefix):
    keys.append(f"{prefix}.gamma" if f"{prefix}.gamma" in sd else f"{prefix}.weight")
    keys.append(f"{prefix}.beta" if f"{prefix}.beta" in sd else f"{prefix}.bias")


def _wavenet(sd, keys, prefix, n_layers, has_cond):
    if has_cond:
        _conv(sd, keys, f"{prefix}.cond_layer", weight_norm=True)
    for i in range(n_layers):
        _conv(sd, keys, f"{prefix}.in_layers.{i}", weight_norm=True)
        _conv(sd, keys, f"{prefix}.res_skip_layers.{i}", weight_norm=True)


def _ddsconv(sd, keys, prefix, n_layers):
    for i in range(n_layers):
        _conv(sd, keys, f"{prefix}.convs_sep.{i}")
        _conv(sd, keys, f"{prefix}.convs_1x1.{i}")
        _layernorm(sd, keys, f"{prefix}.norms_1.{i}")
        _layernorm(sd, keys, f"{prefix}.norms_2.{i}")


def _posterior_encoder(sd, keys, prefix, n_layers, has_cond):
    _conv(sd, keys, f"{prefix}.pre")
    _wavenet(sd, keys, f"{prefix}.enc", n_layers, has_cond)
    _conv(sd, keys, f"{prefix}.proj")


def _coupling_block(sd, keys, prefix, n_flows, n_layers, has_cond):
    for i in range(n_flows):
        cp = f"{prefix}.flows.{2 * i}"
        _conv(sd, keys, f"{cp}.pre")
        _wavenet(sd, keys, f"{cp}.enc", n_layers, has_cond)
        _conv(sd, keys, f"{cp}.post")


def _conv_flow(sd, keys, prefix):
    _conv(sd, keys, f"{prefix}.pre")
    _ddsconv(sd, keys, f"{prefix}.convs", 3)
    _conv(sd, keys, f"{prefix}.proj")


def _sdp(sd, keys, prefix, n_flows, has_cond):
    for name in ("pre", "proj"):
        _conv(sd, keys, f"{prefix}.{name}")
    _ddsconv(sd, keys, f"{prefix}.convs", 3)
    for name in ("post_pre", "post_proj"):
        _conv(sd, keys, f"{prefix}.{name}")
    _ddsconv(sd, keys, f"{prefix}.post_convs", 3)
    for flows in ("flows", "post_flows"):  # ElementwiseAffine
        keys += [f"{prefix}.{flows}.0.m", f"{prefix}.{flows}.0.logs"]
    for i in range(n_flows):
        _conv_flow(sd, keys, f"{prefix}.flows.{1 + 2 * i}")
    for i in range(4):
        _conv_flow(sd, keys, f"{prefix}.post_flows.{1 + 2 * i}")
    if has_cond:
        _conv(sd, keys, f"{prefix}.cond")


def _attention(sd, keys, prefix):
    for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
        _conv(sd, keys, f"{prefix}.{name}")
    if f"{prefix}.emb_rel_k" in sd:
        keys += [f"{prefix}.emb_rel_k", f"{prefix}.emb_rel_v"]


def _text_encoder(sd, keys, prefix, n_layers):
    enc = f"{prefix}.encoder"
    for i in range(n_layers):
        _attention(sd, keys, f"{enc}.attn_layers.{i}")
        _layernorm(sd, keys, f"{enc}.norm_layers_1.{i}")
        _conv(sd, keys, f"{enc}.ffn_layers.{i}.conv_1")
        _conv(sd, keys, f"{enc}.ffn_layers.{i}.conv_2")
        _layernorm(sd, keys, f"{enc}.norm_layers_2.{i}")
    keys += [f"{prefix}.emb.weight", f"{prefix}.emb_t.weight"]
    _conv(sd, keys, f"{prefix}.proj")


def _hifigan(sd, keys, prefix, n_ups, n_kernels, resblock_convs):
    _conv(sd, keys, f"{prefix}.conv_pre")
    if f"{prefix}.cond.weight" in sd:
        _conv(sd, keys, f"{prefix}.cond")
    for i in range(n_ups):
        _conv(sd, keys, f"{prefix}.ups.{i}", weight_norm=True)
        for j in range(n_kernels):
            rp = f"{prefix}.resblocks.{i * n_kernels + j}"
            for k in range(resblock_convs):
                _conv(sd, keys, f"{rp}.convs1.{k}", weight_norm=True)
                _conv(sd, keys, f"{rp}.convs2.{k}", weight_norm=True)
    for i in range(3):
        _conv(sd, keys, f"{prefix}.conv_posts.{i}", bias=False)


def _synthesizer_walk(sd, n_layers_text, n_kernels, resblock_convs, n_ups) -> list[str]:
    keys: list[str] = []
    has_cond = "flow.flows.0.enc.cond_layer.weight_v" in sd
    _text_encoder(sd, keys, "text_encoder", n_layers_text)
    _posterior_encoder(sd, keys, "posterior_encoder", 16, has_cond)
    _posterior_encoder(sd, keys, "pitch_encoder", 16, has_cond)
    _coupling_block(sd, keys, "flow", 4, 4, has_cond)
    _sdp(sd, keys, "duration_predictor", 4, has_cond)
    _hifigan(sd, keys, "waveform_decoder", n_ups, n_kernels, resblock_convs)
    _conv(sd, keys, "yin_decoder.pre")
    _wavenet(sd, keys, "yin_decoder.dec", 4, has_cond)
    _conv(sd, keys, "yin_decoder.proj")
    keys.append("emb_g.weight")
    return keys


def _discriminator_walk(sd) -> list[str]:
    keys: list[str] = []
    for i in range(3):
        p = f"combd.blocks.{i}"
        for j in range(6):
            _conv(sd, keys, f"{p}.convs.{j}", weight_norm=True)
        _conv(sd, keys, f"{p}.projection_conv", weight_norm=True)
    for i in range(4):
        p = f"sbd.discriminators.{i}"
        for j in range(5):
            for k in range(3):
                _conv(sd, keys, f"{p}.convs.{j}.d_convs.{k}", weight_norm=True)
            _conv(sd, keys, f"{p}.convs.{j}.post_conv", weight_norm=True)
        _conv(sd, keys, f"{p}.post_conv", weight_norm=True)
    return keys


def synthesizer_keys(sd: dict, n_layers_text: int = 6, n_kernels: int = 3,
                     resblock_convs: int = 3, n_ups: int = 4) -> set[str]:
    """The keys (``module.`` stripped) that the JAX ``convert_synthesizer``
    reads from the reference generator's ``state_dict`` ``sd``, with the
    same defaults."""
    return set(_synthesizer_walk(_strip_module(sd), n_layers_text, n_kernels,
                                 resblock_convs, n_ups))


def discriminator_keys(sd: dict) -> set[str]:
    """The keys (``module.`` stripped) that the JAX ``convert_discriminator``
    reads from the reference Avocodo discriminator's ``state_dict`` ``sd``
    (a conv's bias where ``sd`` has it, as there)."""
    return set(_discriminator_walk(_strip_module(sd)))


def _select(sd: dict, keys: list[str], what: str) -> dict[str, torch.Tensor]:
    """``sd``'s entries under ``keys`` (in ``sd``'s order), each a
    contiguous CPU copy of its own (a view saved by ``torch.save`` writes
    its whole storage); the rest is dropped and logged."""
    for k in keys:
        if k not in sd:
            raise KeyError(k)
    take = set(keys)
    out = {k: v.detach().cpu().clone().contiguous() for k, v in sd.items() if k in take}
    dropped = [k for k in sd if k not in take]
    log.info("%s: took %d entries, dropped %d the converter does not read%s", what,
             len(out), len(dropped), f" ({', '.join(dropped)})" if dropped else "")
    return out


def convert_synthesizer(sd: dict, n_layers_text: int = 6, n_kernels: int = 3,
                        resblock_convs: int = 3, n_ups: int = 4) -> dict[str, torch.Tensor]:
    """Reference ``SynthesizerTrn`` state_dict -> the port generator's."""
    sd = _strip_module(sd)
    keys = _synthesizer_walk(sd, n_layers_text, n_kernels, resblock_convs, n_ups)
    return _select(sd, keys, "generator")


def convert_discriminator(sd: dict) -> dict[str, torch.Tensor]:
    """Reference ``AvocodoDiscriminator`` state_dict -> the port's."""
    sd = _strip_module(sd)
    return _select(sd, _discriminator_walk(sd), "discriminator")


def convert_checkpoint_file(
    eval_pth: str,
    out_dir: str,
    step: int | None = None,
    train_pth: str | None = None,
) -> str:
    """Convert a reference ``{name}_Eval_{step}.pth`` into the port's
    ``eval_{step}`` file, which ``TTSEngine`` / ``load_eval_params`` load
    directly. With ``train_pth``, also converts the discriminator of
    ``{name}_Train_{step}.pth`` into ``disc_{step}`` (``{"d_params": ...}``,
    for GAN fine-tuning via ``checkpoint.merge_compatible``; the reference's
    optimizer moments are not carried over). The step defaults to the last
    group of digits in ``eval_pth``'s file name. Returns the eval path.

    The architecture is read off the keys after ``module.`` is stripped; the
    JAX converter reads it before (``convert_torch.py:299``), which sizes a
    DDP payload as 0 layers and 0 upsamplings."""
    payload = torch.load(eval_pth, map_location="cpu", weights_only=True)
    sd = payload.get("model_g", payload.get("model", payload))
    g_params = convert_synthesizer(sd, **_detect_arch(_strip_module(sd)))
    d_params = None
    if train_pth is not None:
        tpayload = torch.load(train_pth, map_location="cpu", weights_only=True)
        d_params = convert_discriminator(tpayload.get("model_d", tpayload))
    if step is None:
        digits = re.findall(r"(\d+)", os.path.basename(eval_pth))
        step = int(digits[-1]) if digits else 0

    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    eval_path = os.path.join(out_dir, f"eval_{step}")
    _save({"g_params": g_params}, eval_path)
    if d_params is not None:
        _save({"d_params": d_params}, os.path.join(out_dir, f"disc_{step}"))
    return eval_path


def main(argv=None) -> str:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a reference (torch) VITS checkpoint into the port's format. "
        "Usage: python -m vits_torch.utils.convert_reference Model_Eval_10000.pth "
        "--out-dir exp/converted"
    )
    ap.add_argument("eval_pth", help="reference {name}_Eval_{step}.pth")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--train-pth", default=None,
                    help="optional {name}_Train_{step}.pth (discriminator)")
    ap.add_argument("--step", type=int, default=None,
                    help="step id for the output files (default: from filename)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    path = convert_checkpoint_file(
        args.eval_pth, args.out_dir, step=args.step, train_pth=args.train_pth
    )
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
