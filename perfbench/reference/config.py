"""The generator's constructor arguments from a configuration's sections
(a frozen copy of ``synthesizer_kwargs`` of the program's ``config.py``)."""

from __future__ import annotations


def synthesizer_kwargs(hps, num_chars: int) -> dict:
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
        posterior_layers=int(hps.model.get("posterior_layers", 16)),
        flow_n_flows=int(hps.model.get("flow_n_flows", 4)),
        flow_wn_layers=int(hps.model.get("flow_wn_layers", 4)),
        dur_n_flows=int(hps.model.get("dur_n_flows", 4)),
        yin_dec_layers=int(hps.model.get("yin_dec_layers", 4)),
    )
