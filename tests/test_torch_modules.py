"""Parity of the port's modules (vits_torch) with the JAX package (vits_tpu).

Each test makes its inputs from a seed with numpy, initialises the flax
module, perturbs the parameters that start at zero (flow heads, affine
flows, LayerNorm biases) so no path is trivially the identity, carries the
weights across with ``vits_torch.utils.convert_jax.load_flax_params``, runs
both on the CPU and compares.

Tolerances, by reason:
  F32     rtol 1e-5, atol 1e-5: f32 convolutions, matmuls and layer norms
          summed in another order by XLA and by PyTorch; outputs here are of
          unit scale, where the measured gap is ~1e-6.
  STFT    rtol 1e-5, atol 1e-4: magnitudes of up to ~250 from 1024-term f32
          dot products with the DFT basis, summed in another order.
  SPLINE  rtol 1e-4, atol 1e-4: the inverse spline solves a quadratic whose
          root cancels (-b - sqrt(disc)); f32 rounding there is amplified.
  YIN_F32 rtol 1e-3, atol 1e-3: f32 FFT autocorrelation in another butterfly
          order (pocketfft in PyTorch, ducc in XLA); cMNDF divides by running
          sums of those values.
  YIN_F64 rtol 2e-2, atol 2e-3: f32 against the f64 oracle, the bound the
          JAX package itself holds its f32 Yingram to (tests/test_yin.py).
Integer and index outputs (masks, paths, slices, crops) must match exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vits_tpu.models import attention as j_attention
from vits_tpu.models import duration as j_duration
from vits_tpu.models import flows as j_flows
from vits_tpu.models import hifigan as j_hifigan
from vits_tpu.models import modules as j_modules
from vits_tpu.models import posterior_encoder as j_posterior
from vits_tpu.models import text_encoder as j_text
from vits_tpu.models import ying_decoder as j_ying
from vits_tpu.ops import commons as j_commons
from vits_tpu.ops import spline as j_spline
from vits_tpu.ops import stft as j_stft
from vits_tpu.ops import yin as j_yin

from vits_torch.models import attention as t_attention
from vits_torch.models import duration as t_duration
from vits_torch.models import flows as t_flows
from vits_torch.models import hifigan as t_hifigan
from vits_torch.models import modules as t_modules
from vits_torch.models import posterior_encoder as t_posterior
from vits_torch.models import text_encoder as t_text
from vits_torch.models import ying_decoder as t_ying
from vits_torch.ops import commons as t_commons
from vits_torch.ops import spline as t_spline
from vits_torch.ops import stft as t_stft
from vits_torch.ops import yin as t_yin
from vits_torch.utils.convert_jax import load_flax_params

F32 = dict(rtol=1e-5, atol=1e-5)
STFT = dict(rtol=1e-5, atol=1e-4)
SPLINE = dict(rtol=1e-4, atol=1e-4)
YIN_F32 = dict(rtol=1e-3, atol=1e-3)
YIN_F64 = dict(rtol=2e-2, atol=2e-3)


# -- helpers shared with test_torch_synthesizer -------------------------------


def perturb_zeros(params, seed, std=0.1):
    """Replace every all-zero leaf with N(0, std) values (numpy, seeded)."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if np.any(a):
            return a
        return (rng.standard_normal(a.shape) * std).astype(a.dtype)

    return jax.tree_util.tree_map(fill, params)


def to_torch(a, ncl=False):
    t = torch.from_numpy(np.array(a))
    return t.transpose(1, 2) if ncl else t


def from_torch(t, ncl=False):
    t = t.detach()
    return (t.transpose(1, 2) if ncl else t).numpy()


def _mask(lengths, t):
    """[B, T, 1] f32 sequence mask from lengths."""
    return (np.arange(t)[None, :, None] < np.asarray(lengths)[:, None, None]).astype(
        np.float32
    )


def _port(module, params):
    return load_flax_params(module, params).eval()


# -- ops/commons ---------------------------------------------------------------


def test_sequence_mask_and_generate_path():
    rng = np.random.default_rng(0)
    lengths = np.array([5, 9, 1])
    np.testing.assert_array_equal(
        from_torch(t_commons.sequence_mask(torch.from_numpy(lengths), 9)),
        np.asarray(j_commons.sequence_mask(jnp.asarray(lengths), 9)),
    )
    dur = rng.integers(0, 4, (3, 7)).astype(np.float32)
    mask = _mask([20, 12, 16], 20) * np.swapaxes(_mask([7, 5, 6], 7), 1, 2)
    np.testing.assert_array_equal(
        from_torch(t_commons.generate_path(torch.from_numpy(dur), torch.from_numpy(mask))),
        np.asarray(j_commons.generate_path(jnp.asarray(dur), jnp.asarray(mask))),
    )


def test_slice_segments_clamps_like_dynamic_slice():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 12, 3)).astype(np.float32)
    ids = np.array([0, 5, 9, -3], np.int32)  # 9 is clamped; -3 counts from the end, as in JAX
    np.testing.assert_array_equal(
        from_torch(t_commons.slice_segments(torch.from_numpy(x), torch.from_numpy(ids), 4)),
        np.asarray(j_commons.slice_segments(jnp.asarray(x), jnp.asarray(ids), 4)),
    )


def test_rand_slice_segments_for_cat_duplicates_offsets():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 20, 3)).astype(np.float32)
    lengths = np.array([20, 11, 20, 11], np.int32)
    key = jax.random.PRNGKey(5)
    ref, ref_ids = j_commons.rand_slice_segments_for_cat(
        jnp.asarray(x), jnp.asarray(lengths), 8, key
    )
    u = np.asarray(jax.random.uniform(key, (2,)))
    out, ids = t_commons.rand_slice_segments_for_cat(
        torch.from_numpy(x), torch.from_numpy(lengths), 8, torch.from_numpy(u)
    )
    np.testing.assert_array_equal(from_torch(ids), np.asarray(ref_ids))
    np.testing.assert_array_equal(from_torch(out), np.asarray(ref))
    assert ids[0] == ids[2] and ids[1] == ids[3]


def test_crop_scope_clamps_like_dynamic_slice():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 80)).astype(np.float32)
    shift = np.array([-15, 14, -20, 30], np.int32)  # the last two leave the range
    np.testing.assert_array_equal(
        from_torch(t_commons.crop_scope(torch.from_numpy(x), 15, 50, torch.from_numpy(shift))),
        np.asarray(j_commons.crop_scope(jnp.asarray(x), 15, 50, jnp.asarray(shift))),
    )


# -- models/modules --------------------------------------------------------------


def test_wavenet_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 13, 8)).astype(np.float32)
    mask = _mask([13, 9], 13)
    g = rng.standard_normal((2, 1, 4)).astype(np.float32)
    jm = j_modules.WaveNet(8, 5, 2, 3, gin_channels=4)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(0), x, mask, g), 1)
    ref = jm.apply(params, x, mask, g)
    tm = _port(t_modules.WaveNet(8, 5, 2, 3, gin_channels=4), params)
    out = tm(to_torch(x, True), to_torch(mask, True), to_torch(g, True))
    np.testing.assert_allclose(from_torch(out, True), np.asarray(ref), **F32)


def test_ddsconv_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 10, 12)).astype(np.float32)
    mask = _mask([10, 6], 10)
    g = rng.standard_normal((2, 10, 12)).astype(np.float32)
    jm = j_modules.DDSConv(12, 3, 3)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(0), x, mask, g), 2)
    ref = jm.apply(params, x, mask, g)
    tm = _port(t_modules.DDSConv(12, 3, 3), params)
    out = tm(to_torch(x, True), to_torch(mask, True), to_torch(g, True))
    np.testing.assert_allclose(from_torch(out, True), np.asarray(ref), **F32)


# -- attention + text encoder --------------------------------------------------------


@pytest.mark.parametrize("t", [3, 9])  # shorter and longer than the window + 1
def test_relative_attention_matches_jax(t):
    rng = np.random.default_rng(12 + t)
    x = rng.standard_normal((2, t, 16)).astype(np.float32)
    mask = _mask([t, t - 1], t)
    attn_mask = mask[:, None, :, 0][:, :, None, :] * mask[:, None, :, 0][:, :, :, None]
    jm = j_attention.MultiHeadAttention(16, 16, 2, window_size=4)
    params = jm.init(jax.random.PRNGKey(0), x, x, attn_mask)
    ref = jm.apply(params, x, x, attn_mask)
    tm = _port(t_attention.MultiHeadAttention(16, 16, 2, window_size=4), params)
    out = tm(to_torch(x, True), to_torch(x, True), to_torch(attn_mask))
    np.testing.assert_allclose(from_torch(out, True), np.asarray(ref), **F32)


def test_text_encoder_matches_jax():
    rng = np.random.default_rng(13)
    # ids out of range on purpose: both clip them to the vocabulary
    x = rng.integers(-2, 34, (2, 9))
    t = rng.integers(0, 8, (2, 9))
    lengths = np.array([9, 6])
    jm = j_text.TextEncoder(30, 12, 16, 32, 2, 2, 3, 0.0)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(0), x, t, lengths), 3)
    ref = jm.apply(params, x, t, lengths)
    tm = _port(t_text.TextEncoder(30, 12, 16, 32, 2, 2, 3, 0.0), params)
    out = tm(to_torch(x), to_torch(t), to_torch(lengths))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(from_torch(o, True), np.asarray(r), **F32)


# -- posterior encoder ----------------------------------------------------------------


def test_posterior_encoder_matches_jax():
    rng = np.random.default_rng(14)
    x = np.abs(rng.standard_normal((2, 11, 20))).astype(np.float32)
    lengths = np.array([11, 7])
    g = rng.standard_normal((2, 1, 6)).astype(np.float32)
    jm = j_posterior.PosteriorEncoder(20, 5, 8, 5, 1, 3, gin_channels=6)
    key = jax.random.PRNGKey(7)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(0), x, lengths, g, key), 4)
    ref = jm.apply(params, x, lengths, g, key)
    eps = np.asarray(jax.random.normal(key, (2, 11, 5)))
    tm = _port(t_posterior.PosteriorEncoder(20, 5, 8, 5, 1, 3, gin_channels=6), params)
    out = tm(to_torch(x, True), to_torch(lengths), to_torch(g, True), to_torch(eps, True))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(from_torch(o, True), np.asarray(r), **F32)


# -- flows + spline ------------------------------------------------------------------------


def test_coupling_block_matches_jax_forward_and_reverse():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 10, 12)).astype(np.float32)
    mask = _mask([10, 7], 10)
    g = rng.standard_normal((2, 1, 4)).astype(np.float32)
    jm = j_flows.ResidualCouplingBlock(12, 8, 5, 1, 2, n_flows=2, gin_channels=4)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(0), x, mask, g), 5)
    tm = _port(t_flows.ResidualCouplingBlock(12, 8, 5, 1, 2, n_flows=2, gin_channels=4), params)
    for reverse in (False, True):
        ref = jm.apply(params, x, mask, g, reverse=reverse)
        out = tm(to_torch(x, True), to_torch(mask, True), to_torch(g, True), reverse=reverse)
        np.testing.assert_allclose(from_torch(out, True), np.asarray(ref), **F32)


@pytest.mark.parametrize("inverse", [False, True])
def test_rq_spline_matches_jax(inverse):
    rng = np.random.default_rng(16)
    x = (rng.standard_normal((3, 17)) * 3).astype(np.float32)  # some outside +-5
    x[0, :3] = [-6.0, 5.5, 0.0]
    uw = rng.standard_normal((3, 17, 10)).astype(np.float32)
    uh = rng.standard_normal((3, 17, 10)).astype(np.float32)
    ud = rng.standard_normal((3, 17, 9)).astype(np.float32)
    kw = dict(inverse=inverse, tails="linear", tail_bound=5.0)
    ref = j_spline.piecewise_rational_quadratic_transform(x, uw, uh, ud, **kw)
    out = t_spline.piecewise_rational_quadratic_transform(
        *(torch.from_numpy(a) for a in (x, uw, uh, ud)), **kw
    )
    for r, o in zip(ref, out):
        np.testing.assert_allclose(from_torch(o), np.asarray(r), **SPLINE)


def test_conv_flow_matches_jax_forward_and_reverse():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 9, 2)).astype(np.float32) * 2
    mask = _mask([9, 5], 9)
    g = rng.standard_normal((2, 9, 16)).astype(np.float32)
    jm = j_flows.ConvFlow(2, 16, 3, 3)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(0), x, mask, g), 6, std=0.3)
    tm = _port(t_flows.ConvFlow(2, 16, 3, 3), params)
    for reverse in (False, True):
        ref = jm.apply(params, x, mask, g, reverse=reverse)
        out = tm(to_torch(x, True), to_torch(mask, True), to_torch(g, True), reverse=reverse)
        if reverse:
            np.testing.assert_allclose(from_torch(out, True), np.asarray(ref), **SPLINE)
        else:
            np.testing.assert_allclose(from_torch(out[0], True), np.asarray(ref[0]), **SPLINE)
            np.testing.assert_allclose(from_torch(out[1]), np.asarray(ref[1]), **SPLINE)


def test_elementwise_affine_and_log_match_jax():
    rng = np.random.default_rng(18)
    x = np.abs(rng.standard_normal((2, 6, 2))).astype(np.float32)
    mask = _mask([6, 4], 6)
    jm = j_flows.ElementwiseAffine(2)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(0), x, mask), 7)
    tm = _port(t_flows.ElementwiseAffine(2), params)
    for reverse in (False, True):
        ref = jm.apply(params, x, mask, reverse=reverse)
        out = tm(to_torch(x, True), to_torch(mask, True), reverse=reverse)
        ref, out = (ref, out) if reverse else (ref[0], out[0])
        np.testing.assert_allclose(from_torch(out, True), np.asarray(ref), **F32)
    jl, tl = j_flows.Log(), t_flows.Log()
    ref_y, ref_ld = jl.apply({}, x, mask)
    out_y, out_ld = tl(to_torch(x, True), to_torch(mask, True))
    np.testing.assert_allclose(from_torch(out_y, True), np.asarray(ref_y), **F32)
    np.testing.assert_allclose(from_torch(out_ld), np.asarray(ref_ld), **F32)


# -- stochastic duration predictor ------------------------------------------------------------


@pytest.fixture(scope="module")
def sdp_case():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    mask = _mask([7, 5], 7)
    w = (rng.integers(1, 5, (2, 7, 1)) * mask).astype(np.float32)
    g = rng.standard_normal((2, 1, 8)).astype(np.float32)
    jm = j_duration.StochasticDurationPredictor(16, 24, 3, 0.0, n_flows=2, gin_channels=8)
    params = jax.jit(lambda k: jm.init(k, x, mask, w, g, rng=jax.random.PRNGKey(1)))(
        jax.random.PRNGKey(0)
    )
    params = perturb_zeros(params, 8, std=0.3)
    tm = _port(
        t_duration.StochasticDurationPredictor(16, 24, 3, 0.0, n_flows=2, gin_channels=8),
        params,
    )
    return jm, params, tm, (x, mask, w, g)


def test_sdp_forward_matches_jax(sdp_case):
    jm, params, tm, (x, mask, w, g) = sdp_case
    key = jax.random.PRNGKey(2)
    ref = jax.jit(lambda p: jm.apply(p, x, mask, w, g, rng=key))(params)
    e_q = np.asarray(jax.random.normal(key, (2, 7, 2)))
    out = tm(to_torch(x, True), to_torch(mask, True), to_torch(w, True), to_torch(g, True),
             e_q=to_torch(e_q, True))
    np.testing.assert_allclose(from_torch(out), np.asarray(ref), **SPLINE)


def test_sdp_reverse_matches_jax(sdp_case):
    jm, params, tm, (x, mask, w, g) = sdp_case
    key = jax.random.PRNGKey(3)
    ref = jax.jit(
        lambda p: jm.apply(p, x, mask, g=g, rng=key, noise_scale=0.8,
                           method=j_duration.StochasticDurationPredictor.reverse)
    )(params)
    z = np.asarray(jax.random.normal(key, (2, 7, 2)))
    out = tm.reverse(to_torch(x, True), to_torch(mask, True), to_torch(g, True),
                     z=to_torch(z, True), noise_scale=0.8)
    np.testing.assert_allclose(from_torch(out, True), np.asarray(ref), **SPLINE)


# -- stft + yin ----------------------------------------------------------------------------------


def _voiced(t, seed):
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    x = (
        0.5 * np.sin(2 * np.pi * 110 * n / 22050)
        + 0.2 * np.sin(2 * np.pi * 220 * n / 22050)
        + 0.05 * rng.standard_normal(t)
    )
    return np.stack([x, 0.5 * x[::-1]]).astype(np.float32)


def test_spectrogram_matches_jax():
    x = _voiced(4096, 20)
    ref = j_stft.spectrogram(jnp.asarray(x), 1024, 256, 1024)
    out = t_stft.spectrogram(torch.from_numpy(x), 1024, 256, 1024)
    np.testing.assert_allclose(from_torch(out), np.asarray(ref), **STFT)


def test_yingram_matches_jax_and_numpy_oracle():
    x = _voiced(2048 + 256 * 3, 21)
    args = (22050, 256, 2048, 2048, -5, 75, 24)
    ref_j = np.asarray(j_yin.Yingram(*args)(jnp.asarray(x)))
    ref_np = t_yin.yingram_numpy(x, *args)
    np.testing.assert_array_equal(ref_np, j_yin.yingram_numpy(x, *args))
    out = from_torch(t_yin.Yingram(*args)(torch.from_numpy(x)))
    assert out.shape == ref_j.shape == (2, 4, 80)
    np.testing.assert_allclose(out, ref_j, **YIN_F32)
    np.testing.assert_allclose(out, ref_np, **YIN_F64)


# -- yin decoder ----------------------------------------------------------------------------------


def test_ying_decoder_matches_jax():
    rng = np.random.default_rng(22)
    z_yin = rng.standard_normal((2, 8, 80)).astype(np.float32)
    yin_gt = rng.uniform(0, 1, (2, 8, 80)).astype(np.float32)
    mask = _mask([8, 6], 8)
    g = rng.standard_normal((2, 1, 4)).astype(np.float32)
    jm = j_ying.YingDecoder(50, 5, 1, 2, 15, 50, 15, gin_channels=4)
    key = jax.random.PRNGKey(9)
    params = perturb_zeros(jm.init(jax.random.PRNGKey(0), z_yin, yin_gt, mask, g, key), 9)
    ref = jm.apply(params, z_yin, yin_gt, mask, g, key)
    shift = np.asarray(jax.random.randint(key, (2,), -15, 15))
    tm = _port(t_ying.YingDecoder(50, 5, 1, 2, 15, 50, 15, gin_channels=4), params)
    out = tm(to_torch(z_yin, True), to_torch(yin_gt, True), to_torch(mask, True),
             to_torch(g, True), torch.from_numpy(shift))
    for r, o in zip(ref[:4], out[:4]):
        np.testing.assert_allclose(from_torch(o, True), np.asarray(r), **F32)
    np.testing.assert_array_equal(from_torch(out[4]), np.asarray(ref[4]))


# -- hifigan ----------------------------------------------------------------------------------


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_hifigan_matches_jax(resblock):
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 6, 10)).astype(np.float32)
    g = rng.standard_normal((2, 1, 4)).astype(np.float32)
    args = ("1" if resblock == "1" else "2", (3, 5), ((1, 3), (1, 3)), (4, 2, 2, 2), 16,
            (8, 4, 4, 4))
    jm = j_hifigan.HiFiGANGenerator(10, *args, gin_channels=4)
    params = jax.jit(
        lambda k: jm.init(k, x, g, method=j_hifigan.HiFiGANGenerator.hier_forward)
    )(jax.random.PRNGKey(0))
    refs = jax.jit(
        lambda p: jm.apply(p, x, g, method=j_hifigan.HiFiGANGenerator.hier_forward)
    )(params)
    tm = _port(t_hifigan.HiFiGANGenerator(10, *args, gin_channels=4), params)
    outs = tm.hier_forward(to_torch(x, True), to_torch(g, True))
    assert [o.shape[-1] for o in outs] == [6 * 32 // 4, 6 * 32 // 2, 6 * 32]
    for r, o in zip(refs, outs):
        np.testing.assert_allclose(from_torch(o, True), np.asarray(r), **F32)
    np.testing.assert_allclose(
        from_torch(tm(to_torch(x, True), to_torch(g, True)), True), np.asarray(refs[-1]), **F32
    )
