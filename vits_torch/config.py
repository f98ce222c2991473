"""Config system: YAML -> nested attr-dict HParams.

The port's own copy of ``vits_tpu/config.py`` (the port imports nothing of
the JAX package): the same ``HParams`` access semantics, the same
``get_hparams`` snapshot of a run's config and the same
``synthesizer_kwargs`` mapping, so one YAML file builds the same model in
both packages.
"""

from __future__ import annotations

import os
import shutil

import yaml


class HParams:
    """Recursive attribute/dict hybrid (reference utils.py:271-300)."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def __len__(self):
        return len(self.__dict__)

    def __getitem__(self, key):
        return self.__dict__[key]

    def __setitem__(self, key, value):
        self.__dict__[key] = value

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):
        return repr(self.__dict__)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.__dict__.items():
            out[k] = v.to_dict() if isinstance(v, HParams) else v
        return out


def load_hparams(config_path: str) -> HParams:
    with open(config_path) as f:
        data = yaml.safe_load(f)
    return HParams(**data)


def get_hparams(config_path: str, model_dir: str) -> HParams:
    """Load config, snapshot it into model_dir (reference utils.py:197-211)."""
    os.makedirs(model_dir, exist_ok=True)
    snapshot = os.path.join(model_dir, "config.yaml")
    if os.path.abspath(config_path) != os.path.abspath(snapshot):
        shutil.copyfile(config_path, snapshot)
    hps = load_hparams(config_path)
    hps.model_dir = model_dir
    return hps


def synthesizer_kwargs(hps: HParams, num_chars: int) -> dict:
    """Map config sections onto SynthesizerTrn fields (reference
    train.py:142-153 builds the model from data+model config).

    The model keys ``decoder`` (``hifigan`` | ``mb_istft``, with
    ``subbands``, ``gen_istft_n_fft``, ``gen_istft_hop_size``), ``pitch``
    (``yingram`` | ``none``) and ``language_embedding`` default to the
    PITS model; with ``pitch: none`` the Yingram and yin keys may be left
    out, and an empty speaker list builds a single-speaker model (no
    speaker embedding, ``gin_channels`` 0)."""
    m, d = hps.model, hps.data
    pitch = str(m.get("pitch", "yingram"))
    if pitch == "none":  # the pitch path's keys, unread without it
        yin = dict.fromkeys(("midi_start", "midi_end", "octave_range", "yin_channels",
                             "yin_start", "yin_scope", "yin_shift_range"), 0)
    else:
        yin = dict(midi_start=d.midi_start, midi_end=d.midi_end, octave_range=d.octave_range,
                   yin_channels=m.yin_channels, yin_start=m.yin_start, yin_scope=m.yin_scope,
                   yin_shift_range=m.yin_shift_range)
    n_speakers = len(d.speakers)
    return dict(
        num_chars=num_chars,
        spec_channels=hps.data.filter_length // 2 + 1,
        segment_size=hps.train.segment_size,
        **yin,
        inter_channels=hps.model.inter_channels,
        hidden_channels=hps.model.hidden_channels,
        filter_channels=hps.model.filter_channels,
        n_heads=hps.model.n_heads,
        n_layers=hps.model.n_layers,
        kernel_size=hps.model.kernel_size,
        p_dropout=hps.model.p_dropout,
        resblock=str(hps.model.resblock),
        resblock_kernel_sizes=hps.model.resblock_kernel_sizes,
        resblock_dilation_sizes=hps.model.resblock_dilation_sizes,
        upsample_rates=hps.model.upsample_rates,
        upsample_initial_channel=hps.model.upsample_initial_channel,
        upsample_kernel_sizes=hps.model.upsample_kernel_sizes,
        n_speakers=n_speakers,
        gin_channels=m.gin_channels if n_speakers else 0,
        sampling_rate=hps.data.sampling_rate,
        filter_length=hps.data.filter_length,
        hop_length=hps.data.hop_length,
        # optional depth knobs (flagship defaults match the reference's
        # hard-coded 16/4/4/4/4; small test/probe configs override them to
        # bound XLA compile time)
        posterior_layers=int(hps.model.get("posterior_layers", 16)),
        flow_n_flows=int(hps.model.get("flow_n_flows", 4)),
        flow_wn_layers=int(hps.model.get("flow_wn_layers", 4)),
        dur_n_flows=int(hps.model.get("dur_n_flows", 4)),
        yin_dec_layers=int(hps.model.get("yin_dec_layers", 4)),
        decoder=str(m.get("decoder", "hifigan")),
        subbands=int(m.get("subbands", 4)),
        gen_istft_n_fft=int(m.get("gen_istft_n_fft", 16)),
        gen_istft_hop_size=int(m.get("gen_istft_hop_size", 4)),
        pitch=pitch,
        language_embedding=bool(m.get("language_embedding", True)),
    )
