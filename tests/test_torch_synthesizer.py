"""The whole slice against the JAX package: ``SynthesizerTrn.forward`` (the
JAX ``__call__``) and ``infer`` at a tiny configuration, on the CPU.

Weights: the port model is built from a fixed torch seed, its zero-init
heads are perturbed (numpy, seeded) so flows and splines are not the
identity, and the same numbers reach both packages through
``vits_tpu.utils.convert_torch`` and ``vits_torch.utils.convert_jax``.
Noise: the JAX model draws from one key; the test splits that key exactly as
``synthesizer.py`` does and hands the same arrays to the port.

Tolerance for float outputs: rtol 1e-5, atol 2e-5, the f32 summation-order
gap of XLA against PyTorch through ~40 layers of unit-scale activations
(measured ~1e-6). MAS paths, masks, slice offsets and scope shifts must match
exactly.
"""

import numpy as np
import pytest
import torch

import jax

from vits_tpu.models.synthesizer import SynthesizerTrn as JaxSynthesizer
from vits_tpu.utils import convert_torch as C

from vits_torch.models.synthesizer import SynthesizerTrn
from vits_torch.utils.convert_jax import flax_to_state_dict, load_flax_params

from tests.test_torch_modules import perturb_zeros

TOL = dict(rtol=1e-5, atol=2e-5)
EXACT_KEYS = ("attn", "ids_slice", "scope_shift", "x_mask", "z_mask")

# the tiny configuration of tests/test_synthesizer.py
TINY = dict(
    num_chars=30,
    spec_channels=513,
    segment_size=2048,  # 8 frames
    midi_start=-5,
    midi_end=75,
    octave_range=24,
    inter_channels=96,
    hidden_channels=96,
    filter_channels=128,
    n_heads=2,
    n_layers=1,
    kernel_size=3,
    p_dropout=0.0,
    resblock="1",
    resblock_kernel_sizes=[3],
    resblock_dilation_sizes=[[1, 3]],
    upsample_rates=[8, 8, 2, 2],
    upsample_initial_channel=64,
    upsample_kernel_sizes=[16, 16, 4, 4],
    yin_channels=80,
    yin_start=15,
    yin_scope=50,
    yin_shift_range=15,
    n_speakers=3,
    gin_channels=16,
    posterior_layers=2,
    flow_n_flows=2,
    flow_wn_layers=1,
    dur_n_flows=1,
    yin_dec_layers=2,
)

B, T_X, T_Y, MAX_FRAMES = 2, 11, 24, 64

FORWARD_KEYS = (
    "wav_hier", "l_length", "attn", "ids_slice", "x_mask", "z_mask", "z", "z_p",
    "m_p", "logs_p", "m_q", "logs_q", "z_dec", "z_spec", "m_spec", "logs_spec",
    "z_yin", "m_yin", "logs_yin", "yin_gt_crop", "yin_gt_shifted_crop",
    "yin_dec_crop", "yin_hat_crop", "scope_shift", "yin_hat_shifted",
)


def _batch():
    rng = np.random.default_rng(0)
    x = rng.integers(1, 30, (B, T_X))
    t = rng.integers(0, 6, (B, T_X))
    x_lengths = np.array([T_X, T_X - 3])
    spec = np.abs(rng.standard_normal((B, T_Y, 513))).astype(np.float32)
    ying = rng.uniform(0, 1, (B, T_Y, 80)).astype(np.float32)
    y_lengths = np.array([T_Y, T_Y - 5])
    sid = np.array([0, 2])
    return x, t, x_lengths, spec, y_lengths, ying, sid


def _flax_params(sd):
    """Port state_dict -> flax tree with the converter's own helpers."""
    return {
        "params": {
            "text_encoder": C._text_encoder(sd, "text_encoder", TINY["n_layers"]),
            "posterior_encoder": C._posterior_encoder(
                sd, "posterior_encoder", TINY["posterior_layers"], True
            ),
            "pitch_encoder": C._posterior_encoder(
                sd, "pitch_encoder", TINY["posterior_layers"], True
            ),
            "flow": C._coupling_block(
                sd, "flow", TINY["flow_n_flows"], TINY["flow_wn_layers"], True
            ),
            "duration_predictor": C._sdp(sd, "duration_predictor", TINY["dur_n_flows"], True),
            "waveform_decoder": C._hifigan(
                sd, "waveform_decoder", 4, len(TINY["resblock_kernel_sizes"]),
                len(TINY["resblock_dilation_sizes"][0]),
            ),
            "yin_decoder": C._ying_decoder(sd, "yin_decoder", TINY["yin_dec_layers"], True),
            "emb_g": {"embedding": C._np(sd["emb_g.weight"])},
        }
    }


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        fresh = SynthesizerTrn(**TINY, device="cpu")
    params = perturb_zeros(_flax_params(fresh.state_dict()), seed=1)
    port = load_flax_params(SynthesizerTrn(**TINY, device="cpu"), params).eval()
    return JaxSynthesizer(**TINY), params, port, fresh


@pytest.fixture(scope="module")
def forward_pair(models):
    jm, params, port, _ = models
    x, t, xl, spec, yl, ying, sid = _batch()
    key = jax.random.PRNGKey(2)
    ref = jax.jit(lambda p: jm.apply(p, x, t, xl, spec, yl, ying, sid, rng=key))(params)
    r_spec, r_yin, r_yindec, r_dur, r_slice = jax.random.split(key, 5)
    spec_ch = TINY["inter_channels"] - TINY["yin_channels"]
    noise = {
        "eps_spec": jax.random.normal(r_spec, (B, T_Y, spec_ch)),
        "eps_yin": jax.random.normal(r_yin, (B, T_Y, TINY["yin_channels"])),
        "scope_shift": jax.random.randint(r_yindec, (B,), -15, 15),
        "e_q": jax.random.normal(r_dur, (B, T_X, 2)),
        "slice_u": jax.random.uniform(r_slice, (B,)),
    }
    noise = {k: np.asarray(v) for k, v in noise.items()}
    with torch.no_grad():
        out = port(_t(x), _t(t), _t(xl), _t(spec), _t(yl), _t(ying), _t(sid), noise=noise)
    return ref, out


@pytest.mark.parametrize("key", FORWARD_KEYS)
def test_forward_matches_jax(forward_pair, key):
    ref, out = forward_pair
    assert set(out) == set(ref) == set(FORWARD_KEYS)
    refs = ref[key] if key == "wav_hier" else [ref[key]]
    outs = out[key] if key == "wav_hier" else [out[key]]
    assert len(outs) == len(refs)
    for r, o in zip(refs, outs):
        r, o = np.asarray(r), o.numpy()
        assert o.shape == r.shape and o.dtype == r.dtype
        if key in EXACT_KEYS:
            np.testing.assert_array_equal(o, r)
        else:
            np.testing.assert_allclose(o, r, **TOL)


def test_forward_alignment_covers_every_frame(forward_pair):
    _, out = forward_pair
    attn = out["attn"].numpy()
    np.testing.assert_array_equal(attn.sum(axis=(1, 2)), [T_Y, T_Y - 5])
    assert set(np.unique(attn)) <= {0.0, 1.0}


@pytest.fixture(scope="module")
def infer_pair(models):
    jm, params, port, _ = models
    x, t, xl, *_, sid = _batch()
    key = jax.random.PRNGKey(3)
    ref = jax.jit(
        lambda p: jm.apply(
            p, x, t, xl, sid=sid, rng=key, max_frames=MAX_FRAMES,
            method=JaxSynthesizer.infer,
        )
    )(params)
    r_dur, r_noise = jax.random.split(key, 2)
    noise = {
        "sdp_noise": np.asarray(jax.random.normal(r_dur, (B, T_X, 2))),
        "eps": np.asarray(
            jax.random.normal(r_noise, (B, MAX_FRAMES, TINY["inter_channels"]))
        ),
    }
    with torch.no_grad():
        out = port.infer(_t(x), _t(t), _t(xl), _t(sid), noise=noise, max_frames=MAX_FRAMES)
    return ref, out


def test_infer_waveform_matches_jax(infer_pair):
    (wav, _, _), (wav_t, _, _) = infer_pair
    assert wav_t.shape == (B, MAX_FRAMES * 256, 1)
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav), **TOL)


def test_infer_lengths_and_mask_match_jax(infer_pair):
    (_, y_mask, y_lengths), (_, y_mask_t, y_lengths_t) = infer_pair
    np.testing.assert_array_equal(y_lengths_t.numpy(), np.asarray(y_lengths))
    np.testing.assert_array_equal(y_mask_t.numpy(), np.asarray(y_mask))


def test_weight_round_trip_is_exact(models):
    """port state_dict -> convert_torch helpers -> load_flax_params -> the
    same state_dict, key for key and bit for bit."""
    _, _, _, fresh = models
    sd = fresh.state_dict()
    back = flax_to_state_dict(fresh, _flax_params(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy(), err_msg=k)
