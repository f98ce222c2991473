"""Config system: YAML -> nested attr-dict HParams.

The port's own copy of ``vits_tpu/config.py`` (the port imports nothing of
the JAX package): the same ``HParams`` access semantics and the same
``synthesizer_kwargs`` mapping, so one YAML file builds the same model in
both packages.
"""

from __future__ import annotations

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


def synthesizer_kwargs(hps: HParams, num_chars: int) -> dict:
    """Map config sections onto SynthesizerTrn fields (reference
    train.py:142-153 builds the model from data+model config)."""
    return dict(
        num_chars=num_chars,
        spec_channels=hps.data.filter_length // 2 + 1,
        segment_size=hps.train.segment_size,
        midi_start=hps.data.midi_start,
        midi_end=hps.data.midi_end,
        octave_range=hps.data.octave_range,
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
        yin_channels=hps.model.yin_channels,
        yin_start=hps.model.yin_start,
        yin_scope=hps.model.yin_scope,
        yin_shift_range=hps.model.yin_shift_range,
        n_speakers=len(hps.data.speakers),
        gin_channels=hps.model.gin_channels,
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
    )
