"""The remaining inference entry points against the JAX package, on the CPU:
the staged ``infer_pre_lr`` / ``infer_lr`` / ``infer_post_lr_pre_decoder``,
``yin_dec_infer`` and ``voice_conversion``, at the tiny configuration of
``tests/test_torch_synthesizer.py`` with the same perturbed weights.

Noise: each JAX method draws from one key; the test draws the same arrays
from that key, split as ``vits_tpu/models/synthesizer.py`` splits it, and
hands them to the port through ``noise=``. Tolerance rtol 1e-5, atol 2e-5,
as for ``infer`` (the f32 summation-order gap of XLA against PyTorch);
masks and lengths exact.
"""

import numpy as np
import pytest
import torch

import jax

from vits_tpu.models.synthesizer import SynthesizerTrn as JaxSynthesizer
from vits_tpu.ops import commons as jcommons

from vits_torch.models.synthesizer import SynthesizerTrn
from vits_torch.ops import commons
from vits_torch.utils.convert_jax import load_flax_params

from tests.test_torch_modules import perturb_zeros
from tests.test_torch_synthesizer import TINY, _flax_params

TOL = dict(rtol=1e-5, atol=2e-5)
B, T_X, T_Y, MAX_FRAMES = 2, 11, 24, 64
SPEC_CH = TINY["inter_channels"] - TINY["yin_channels"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref):
    ref = np.asarray(ref)
    out = out.detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.fixture(scope="module")
def models():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        fresh = SynthesizerTrn(**TINY, device="cpu")
    params = perturb_zeros(_flax_params(fresh.state_dict()), seed=1)
    port = load_flax_params(SynthesizerTrn(**TINY, device="cpu"), params).eval()
    return JaxSynthesizer(**TINY), params, port


def _text():
    rng = np.random.default_rng(0)
    x = rng.integers(1, 30, (B, T_X))
    t = rng.integers(0, 6, (B, T_X))
    return x, t, np.array([T_X, T_X - 3]), np.array([0, 2])


@pytest.fixture(scope="module")
def pre_lr(models):
    jm, params, port = models
    x, t, xl, sid = _text()
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda p: jm.apply(
        p, x, t, xl, sid=sid, rng=key, length_scale=1.3, noise_scale_w=0.8,
        method=JaxSynthesizer.infer_pre_lr,
    ))(params)
    # infer_pre_lr hands its key to the SDP reverse unsplit
    noise = {"sdp_noise": np.asarray(jax.random.normal(key, (B, T_X, 2)))}
    with torch.no_grad():
        out = port.infer_pre_lr(
            _t(x), _t(t), _t(xl), _t(sid), noise=noise, length_scale=1.3, noise_scale_w=0.8
        )
    return ref, out


@pytest.mark.parametrize("i,name", enumerate(["w_ceil", "x_h", "m_p", "logs_p", "x_mask", "g"]))
def test_infer_pre_lr_matches_jax(pre_lr, i, name):
    ref, out = pre_lr
    assert len(out) == len(ref) == 6
    if name in ("w_ceil", "x_mask"):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]))
    else:
        _close(out[i], ref[i])


def test_infer_lr_matches_jax(models, pre_lr):
    jm, params, port = models
    (w_ceil, _, m_p, logs_p, x_mask, _), _ = pre_lr
    ref = jm.apply(params, w_ceil, m_p, logs_p, x_mask, max_frames=MAX_FRAMES,
                   method=JaxSynthesizer.infer_lr)
    with torch.no_grad():
        out = port.infer_lr(*(_t(a) for a in (w_ceil, m_p, logs_p, x_mask)), max_frames=MAX_FRAMES)
    _close(out[0], ref[0])
    _close(out[1], ref[1])
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("scope_shift", [0, 7, -15])
def test_infer_post_lr_pre_decoder_matches_jax(models, pre_lr, scope_shift):
    jm, params, port = models
    (w_ceil, _, m_p, logs_p, x_mask, g), _ = pre_lr
    m_exp, logs_exp, y_mask = jm.apply(params, w_ceil, m_p, logs_p, x_mask,
                                       max_frames=MAX_FRAMES, method=JaxSynthesizer.infer_lr)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p: jm.apply(
        p, m_exp, logs_exp, g, y_mask, rng=key, noise_scale=0.667, scope_shift=scope_shift,
        method=JaxSynthesizer.infer_post_lr_pre_decoder,
    ))(params)
    noise = {"eps": np.asarray(jax.random.normal(key, m_exp.shape))}
    with torch.no_grad():
        out = port.infer_post_lr_pre_decoder(
            *(_t(a) for a in (m_exp, logs_exp, g, y_mask)), noise=noise, noise_scale=0.667,
            scope_shift=scope_shift,
        )
    _close(out[0], ref[0])
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    assert len(out[2]) == len(ref[2]) == 5
    for o, r in zip(out[2], ref[2]):
        _close(o, r)


def test_staged_chain_equals_infer(models):
    """infer_pre_lr -> infer_lr -> infer_post_lr_pre_decoder ->
    infer_decode_chunk is infer, given the same draws."""
    _, _, port = models
    x, t, xl, sid = (_t(a) for a in _text())
    rng = np.random.default_rng(6)
    noise = {
        "sdp_noise": rng.standard_normal((B, T_X, 2)).astype(np.float32),
        "eps": rng.standard_normal((B, MAX_FRAMES, TINY["inter_channels"])).astype(np.float32),
    }
    kw = dict(noise_scale=0.667, noise_scale_w=0.8, length_scale=1.1)
    with torch.no_grad():
        wav, y_mask, y_lengths = port.infer(x, t, xl, sid, noise=noise, max_frames=MAX_FRAMES,
                                            scope_shift=4, **kw)
        w_ceil, _, m_p, logs_p, x_mask, g = port.infer_pre_lr(
            x, t, xl, sid, noise=noise, length_scale=1.1, noise_scale_w=0.8
        )
        m_exp, logs_exp, y_mask_s = port.infer_lr(w_ceil, m_p, logs_p, x_mask, max_frames=MAX_FRAMES)
        dec_in, _, _ = port.infer_post_lr_pre_decoder(
            m_exp, logs_exp, g, y_mask_s, noise=noise, noise_scale=0.667, scope_shift=4
        )
        wav_s = port.infer_decode_chunk(dec_in, sid)
    np.testing.assert_array_equal(y_mask_s.numpy(), y_mask.numpy())
    np.testing.assert_array_equal(
        w_ceil.sum(dim=(1, 2)).clamp(1, MAX_FRAMES).int().numpy(), y_lengths.numpy()
    )
    np.testing.assert_allclose(wav_s.numpy(), wav.numpy(), rtol=1e-6, atol=1e-6)


def test_infer_per_row_duration_and_shift_equal_rows_alone(models):
    """One length_scale and one scope_shift a row (the engine's batches)
    gives each row what it gives alone with its scalars."""
    _, _, port = models
    x, t, xl, sid = (_t(a) for a in _text())
    rng = np.random.default_rng(7)
    noise = {
        "sdp_noise": rng.standard_normal((B, T_X, 2)).astype(np.float32),
        "eps": rng.standard_normal((B, MAX_FRAMES, TINY["inter_channels"])).astype(np.float32),
    }
    durs, shifts = [0.8, 1.4], [-9, 12]
    with torch.no_grad():
        wav, _, y_len = port.infer(
            x, t, xl, sid, noise=noise, max_frames=MAX_FRAMES,
            length_scale=torch.tensor(durs), scope_shift=torch.tensor(shifts),
        )
        for r in range(B):
            row_noise = {k: v[r:r + 1] for k, v in noise.items()}
            w_r, _, yl_r = port.infer(
                x[r:r + 1], t[r:r + 1], xl[r:r + 1], sid[r:r + 1], noise=row_noise,
                max_frames=MAX_FRAMES, length_scale=durs[r], scope_shift=shifts[r],
            )
            assert int(yl_r[0]) == int(y_len[r])
            np.testing.assert_allclose(wav[r].numpy(), w_r[0].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_yin_dec_infer_matches_jax(models, seed):
    jm, params, port = models
    rng = np.random.default_rng(10 + seed)
    z_yin = rng.standard_normal((B, T_Y, TINY["yin_channels"])).astype(np.float32)
    z_mask = (np.arange(T_Y)[None, :, None] < np.array([T_Y, T_Y - 6])[:, None, None])
    z_mask = z_mask.astype(np.float32)
    sid = np.array([1, 2])
    key = jax.random.PRNGKey(seed)
    ref = jm.apply(params, z_yin, z_mask, sid, rng=key, method=JaxSynthesizer.yin_dec_infer)
    r = TINY["yin_shift_range"]
    noise = {"scope_shift": np.asarray(jax.random.randint(key, (B,), -r, r))}
    with torch.no_grad():
        out = port.yin_dec_infer(_t(z_yin), _t(z_mask), _t(sid), noise=noise)
    assert out.shape == (B, T_Y, TINY["yin_scope"])
    _close(out, ref)


def test_yin_decoder_infer_draws_its_shift_from_the_generator(models):
    _, _, port = models
    dec = port.yin_decoder
    rng = np.random.default_rng(3)
    z_yin = _t(rng.standard_normal((B, TINY["yin_channels"], T_Y)).astype(np.float32))
    z_mask = torch.ones(B, 1, T_Y)
    with torch.no_grad():
        drawn = dec.infer(z_yin, z_mask, generator=torch.Generator().manual_seed(9))
        shift = dec.draw_shift(B, torch.Generator().manual_seed(9))
        given = dec.infer(z_yin, z_mask, shift=shift)
    assert shift.dtype == torch.int32
    assert ((shift >= -TINY["yin_shift_range"]) & (shift < TINY["yin_shift_range"])).all()
    np.testing.assert_array_equal(drawn.numpy(), given.numpy())


@pytest.fixture(scope="module")
def vc_inputs():
    rng = np.random.default_rng(12)
    spec = np.abs(rng.standard_normal((B, T_Y, 513))).astype(np.float32)
    ying = rng.uniform(0, 1, (B, T_Y, TINY["yin_channels"])).astype(np.float32)
    return spec, ying, np.array([T_Y, T_Y - 5]), np.array([0, 2]), np.array([1, 0])


@pytest.mark.parametrize("scope_shift", [0, -6])
def test_voice_conversion_matches_jax(models, vc_inputs, scope_shift):
    jm, params, port = models
    spec, ying, yl, src, tgt = vc_inputs
    key = jax.random.PRNGKey(8)
    ref = jax.jit(lambda p: jm.apply(
        p, spec, ying, yl, src, tgt, rng=key, scope_shift=scope_shift,
        method=JaxSynthesizer.voice_conversion,
    ))(params)
    r_spec, r_yin = jax.random.split(key, 2)
    noise = {
        "eps_spec": np.asarray(jax.random.normal(r_spec, (B, T_Y, SPEC_CH))),
        "eps_yin": np.asarray(jax.random.normal(r_yin, (B, T_Y, TINY["yin_channels"]))),
    }
    with torch.no_grad():
        o_hat, y_mask, aux = port.voice_conversion(
            *(_t(a) for a in (spec, ying, yl, src, tgt)), noise=noise, scope_shift=scope_shift
        )
    assert o_hat.shape == (B, T_Y * 256, 1)
    _close(o_hat, ref[0])
    np.testing.assert_array_equal(y_mask.numpy(), np.asarray(ref[1]))
    for o, r in zip(aux, ref[2]):
        _close(o, r)


def test_voice_conversion_needs_speakers():
    tiny = dict(TINY, n_speakers=0, gin_channels=0)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        port = SynthesizerTrn(**tiny, device="cpu")
    y = torch.zeros(1, 8, 513)
    with pytest.raises(ValueError, match="multi-speaker"):
        port.voice_conversion(y, torch.zeros(1, 8, 80), torch.tensor([8]), None, None)


def test_intersperse_with_language_id_matches_jax():
    for seq, lang in (([5, 9, 12], [0, 3, 1]), (np.array([4]), np.array([1])),
                      (list(range(1, 20)), [i % 4 for i in range(19)])):
        out = commons.intersperse_with_language_id(seq, lang, 0)
        ref = jcommons.intersperse_with_language_id(seq, lang, 0)
        assert [list(map(int, a)) for a in out] == [list(map(int, a)) for a in ref]


@pytest.mark.parametrize("length", [1, 5, 17])
def test_subsequent_mask_matches_jax(length):
    out = commons.subsequent_mask(length)
    ref = np.asarray(jcommons.subsequent_mask(length))
    assert out.shape == ref.shape == (1, 1, length, length)
    np.testing.assert_array_equal(out.numpy(), ref)
