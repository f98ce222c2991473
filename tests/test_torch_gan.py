"""Parity of the port's GAN side (vits_torch) with the JAX package (vits_tpu):
mel, PQMF, PhaseAug, the losses, the Avocodo discriminator with its weight
conversion, and the bf16 compute policy, on the CPU with inputs made from
seeds by numpy.

Tolerances, by reason:
  F32    rtol 1e-5, atol 1e-5: f32 convolutions, FFTs and matmuls summed in
         another order by XLA and by PyTorch, outputs of unit scale.
  MEL    rtol 1e-5, atol 1e-4: log-mels from 1024-term f32 DFT dot products
         and 513-term filterbank sums, values up to ~10.
  PQMF   rtol 1e-4, atol 1e-5: synthesis sums 257 taps x up to 64 bands of
         unit-scale sub-bands into values up to ~50, in another order.
  DISC   rtol 1e-4, atol 1e-5: the flagship discriminator chains grouped
         convs of 41 taps over up to 1024 channels; f32 sums of that length
         in another order.
  LOSS   rtol 1e-6: the same f32 reductions over the same values.
  BF16   the port's bf16 output lies within twice the JAX package's own
         bf16-vs-f32 gap of the JAX bf16 output (both round at other places).
Weight conversions are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vits_tpu.models import avocodo as j_avocodo
from vits_tpu.models import hifigan as j_hifigan
from vits_tpu.models import posterior_encoder as j_posterior
from vits_tpu.ops import phaseaug as j_phaseaug
from vits_tpu.ops import pqmf as j_pqmf
from vits_tpu.ops import stft as j_stft
from vits_tpu.training import losses as j_losses
from vits_tpu.utils import convert_torch as C

from vits_torch.models import avocodo as t_avocodo
from vits_torch.models import hifigan as t_hifigan
from vits_torch.models import posterior_encoder as t_posterior
from vits_torch.ops import phaseaug as t_phaseaug
from vits_torch.ops import pqmf as t_pqmf
from vits_torch.ops import stft as t_stft
from vits_torch.training import losses as t_losses
from vits_torch.utils.convert_jax import flax_to_state_dict, load_flax_params

from tests.test_torch_modules import from_torch, perturb_zeros, to_torch

F32 = dict(rtol=1e-5, atol=1e-5)
MEL = dict(rtol=1e-5, atol=1e-4)
PQMF = dict(rtol=1e-4, atol=1e-5)
DISC = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-6, atol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- mel --------------------------------------------------------------------------------


@pytest.mark.parametrize("fmax", [None, 8000.0])
def test_mel_filterbank_matches_jax(fmax):
    ref = j_stft.mel_filterbank(22050, 1024, 80, 0.0, fmax)
    np.testing.assert_array_equal(t_stft.mel_filterbank(22050, 1024, 80, 0.0, fmax), ref)


def test_mel_spectrogram_and_spec_to_mel_match_jax():
    rng = np.random.default_rng(30)
    y = (rng.standard_normal((2, 4096)) * 0.3).astype(np.float32)
    args = (1024, 80, 22050, 256, 1024, 0.0, None)
    ref = np.asarray(j_stft.mel_spectrogram(y, *args))
    out = t_stft.mel_spectrogram(_t(y), *args).numpy()
    assert out.shape == ref.shape == (2, 16, 80) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **MEL)
    spec = np.abs(rng.standard_normal((2, 7, 513))).astype(np.float32)
    np.testing.assert_allclose(
        t_stft.spec_to_mel(_t(spec), 1024, 80, 22050, 0.0, None).numpy(),
        np.asarray(j_stft.spec_to_mel(spec, 1024, 80, 22050, 0.0, None)), **MEL,
    )
    x = rng.uniform(0, 2, (3, 5)).astype(np.float32)
    np.testing.assert_allclose(t_stft.spectral_normalize(_t(x)).numpy(),
                               np.asarray(j_stft.spectral_normalize(x)), **F32)
    np.testing.assert_allclose(t_stft.spectral_de_normalize(_t(x)).numpy(),
                               np.asarray(j_stft.spectral_de_normalize(x)), **F32)


# -- PQMF -------------------------------------------------------------------------------


# every bank the discriminators build: CoMBD's two, SBD's time and frequency ones
BANKS = [(4, 192, 0.13, 10.0), (2, 256, 0.25, 10.0), (16, 256, 0.03, 10.0),
         (64, 256, 0.1, 9.0)]


@pytest.mark.parametrize("bank", BANKS, ids=lambda b: f"N{b[0]}")
def test_pqmf_analysis_and_synthesis_match_jax(bank):
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 2048, 1)).astype(np.float32)
    jp, tp = j_pqmf.PQMF(*bank), t_pqmf.PQMF(*bank)
    ref = np.asarray(jp.analysis(x))
    out = tp.analysis(_t(x)).numpy()
    assert out.shape == ref.shape == (2, 2048 // bank[0], bank[0])
    np.testing.assert_allclose(out, ref, **F32)
    np.testing.assert_allclose(tp.synthesis(_t(ref)).numpy(),
                               np.asarray(jp.synthesis(ref)), **PQMF)


def test_pqmf_filters_are_the_jax_filters():
    for bank in BANKS:
        for a, b in zip(t_pqmf._pqmf_filters(*bank), j_pqmf._pqmf_filters(*bank)):
            np.testing.assert_array_equal(a, b)


# -- PhaseAug ----------------------------------------------------------------------------


def test_lowpass_kernel_is_the_jax_kernel():
    np.testing.assert_array_equal(t_phaseaug._lowpass_kernel(), j_phaseaug._lowpass_kernel())


def test_sample_phi_matches_jax_on_the_same_draws():
    key = jax.random.PRNGKey(5)
    ref = np.asarray(j_phaseaug.sample_phi(key, 3))
    r_phi, r_delta = jax.random.split(key)
    phi_raw = np.asarray(jax.random.normal(r_phi, (3, 513)))
    u = np.asarray(jax.random.uniform(r_delta, (3, 1)))
    out = t_phaseaug.phi_from_noise(_t(phi_raw), _t(u)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert (out[:, 0] == 0).all()
    drawn = t_phaseaug.sample_phi(3, torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 513) and torch.isfinite(drawn).all()


@pytest.fixture(scope="module")
def phase_case():
    rng = np.random.default_rng(32)
    x = (rng.standard_normal((2, 2048)) * 0.3).astype(np.float32)
    phi = np.asarray(j_phaseaug.sample_phi(jax.random.PRNGKey(6), 2))
    return x, phi


@pytest.mark.parametrize("use_fft", [True, False], ids=["fft", "matmul"])
def test_apply_phi_stft_matches_jax(phase_case, use_fft):
    x, phi = phase_case
    ref = np.asarray(j_phaseaug.apply_phi_stft(x, phi, use_fft=use_fft))
    out = t_phaseaug.apply_phi_stft(_t(x), _t(phi), use_fft=use_fft).numpy()
    np.testing.assert_allclose(out, ref, **F32)


def test_rotate_frames_matmul_matches_jax_and_the_fft_path(phase_case):
    _, phi = phase_case
    frames = np.random.default_rng(33).standard_normal((2, 5, 1024)).astype(np.float32)
    ref = np.asarray(j_phaseaug._rotate_frames_matmul(frames, phi))
    out = t_phaseaug._rotate_frames_matmul(_t(frames), _t(phi))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    spec = torch.fft.rfft(_t(frames), dim=-1) * torch.polar(torch.ones(2, 513), _t(phi))[:, None]
    np.testing.assert_allclose(out.numpy(), torch.fft.irfft(spec, n=1024).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_apply_allpass_matches_jax(phase_case):
    x, phi = phase_case
    ref = np.asarray(j_phaseaug.apply_allpass(x, phi))
    np.testing.assert_allclose(t_phaseaug.apply_allpass(_t(x), _t(phi)).numpy(), ref, **F32)


@pytest.mark.parametrize("exact", [True, False])
def test_phaseaug_sync_matches_jax(phase_case, exact):
    x, _ = phase_case
    y, y_hat = x[:, :, None], (x[::-1, :, None] * 0.5).copy()
    phi = np.asarray(j_phaseaug.sample_phi(jax.random.PRNGKey(7), 2))
    refs = j_phaseaug.phaseaug_sync(y, y_hat, None, phi=phi, exact=exact)
    outs = t_phaseaug.phaseaug_sync(_t(y), _t(y_hat), phi=_t(phi), exact=exact)
    for r, o in zip(refs, outs):
        assert o.shape == r.shape == (2, 2048, 1)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **F32)


# -- losses ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_case():
    rng = np.random.default_rng(34)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    outs_r, outs_g = [arr(2, 5, 1), arr(2, 7, 1)], [arr(2, 5, 1), arr(2, 7, 1)]
    fmaps_r = [[arr(2, 9, 3), arr(2, 4, 6)], [arr(2, 8, 2)]]
    fmaps_g = [[arr(2, 9, 3), arr(2, 4, 6)], [arr(2, 8, 2)]]
    kl = [arr(2, 6, 4), arr(2, 6, 4), arr(2, 6, 4), arr(2, 6, 4) * 0.3,
          (np.arange(6)[None, :, None] < np.array([6, 4])[:, None, None]).astype(np.float32)]
    return outs_r, outs_g, fmaps_r, fmaps_g, kl


def _tt(tree):
    return [_tt(a) for a in tree] if isinstance(tree, list) else _t(tree)


@pytest.mark.parametrize("name", ["feature", "discriminator", "generator", "kl"])
def test_loss_matches_jax(loss_case, name):
    outs_r, outs_g, fmaps_r, fmaps_g, kl = loss_case
    if name == "feature":
        refs = [j_losses.feature_loss(fmaps_r, fmaps_g)]
        outs = [t_losses.feature_loss(_tt(fmaps_r), _tt(fmaps_g))]
    elif name == "discriminator":
        r, rs, gs = j_losses.discriminator_loss(outs_r, outs_g)
        refs = [r, *rs, *gs]
        o, os_, og = t_losses.discriminator_loss(_tt(outs_r), _tt(outs_g))
        outs = [o, *os_, *og]
    elif name == "generator":
        r, rs = j_losses.generator_loss(outs_g)
        refs = [r, *rs]
        o, os_ = t_losses.generator_loss(_tt(outs_g))
        outs = [o, *os_]
    else:
        refs = [j_losses.kl_loss(*kl)]
        outs = [t_losses.kl_loss(*_tt(kl))]
    for r, o in zip(refs, outs):
        assert o.dtype == torch.float32 and o.ndim == 0
        np.testing.assert_allclose(o.item(), float(r), **LOSS)


def test_feature_loss_detaches_the_real_maps():
    r = torch.ones(1, 3, 2, requires_grad=True)
    g = torch.zeros(1, 3, 2, requires_grad=True)
    t_losses.feature_loss([[r]], [[g]]).backward()
    assert r.grad is None and g.grad is not None


# -- the Avocodo discriminator -------------------------------------------------------------


def _disc_inputs(b, seg, seed, b_hat=None):
    rng = np.random.default_rng(seed)
    b_hat = b_hat or b
    y = (rng.standard_normal((b, seg, 1)) * 0.3).astype(np.float32)
    ys_hat = [(rng.standard_normal((b_hat, seg // s, 1)) * 0.3).astype(np.float32)
              for s in (4, 2, 1)]
    return y, ys_hat


def _disc_pair(combd_cfg, sbd_cfg, b, seg, seed, bf16=False):
    y, ys_hat = _disc_inputs(b, seg, seed)
    jd = j_avocodo.AvocodoDiscriminator(combd_cfg=combd_cfg, sbd_cfg=sbd_cfg)
    params = jax.jit(jd.init)(jax.random.PRNGKey(seed), y, ys_hat)
    td = t_avocodo.AvocodoDiscriminator(combd_cfg, sbd_cfg, bf16=bf16, segment_size=seg,
                                        device="cpu")
    return jd, params, load_flax_params(td, params).eval(), y, ys_hat


def _compare_disc(ref, out, tol):
    names = ("real logits", "generated logits", "real fmaps", "generated fmaps")
    for name, r_list, o_list in zip(names, ref, out):
        assert len(r_list) == len(o_list) == 7, name  # CoMBD 3 + SBD 4
        for r, o in zip(jax.tree_util.tree_leaves(r_list), jax.tree_util.tree_leaves(
                [[a.detach().float().numpy() for a in x] if isinstance(x, list)
                 else x.detach().float().numpy() for x in o_list])):
            assert o.shape == r.shape, name
            np.testing.assert_allclose(o, np.asarray(r, np.float32), **tol, err_msg=name)


@pytest.fixture(scope="module")
def probe_disc():
    return _disc_pair(j_avocodo.COMBD_PROBE, j_avocodo.SBD_PROBE, 2, 2048, 40)


@pytest.fixture(scope="module")
def flagship_disc():
    return _disc_pair(j_avocodo.COMBD_FLAGSHIP, j_avocodo.SBD_FLAGSHIP, 1, 2048, 41)


@pytest.mark.parametrize("which", ["probe", "flagship"])
def test_discriminator_matches_jax(request, which):
    jd, params, td, y, ys_hat = request.getfixturevalue(f"{which}_disc")
    ref = jax.jit(jd.apply)(params, y, ys_hat)
    with torch.no_grad():
        out = td(_t(y), [_t(a) for a in ys_hat])
    _compare_disc(ref, out, DISC)


def test_discriminator_tiles_real_outputs_for_a_larger_generated_batch(probe_disc):
    """CoMBD's first two blocks see 2x the generated rows (the PQMF
    projections); their real logits and fmaps are tiled 2x to align."""
    _, _, td, y, ys_hat = probe_disc
    with torch.no_grad():
        y_r, y_g, f_r, f_g = td(_t(y), [_t(a) for a in ys_hat])
    assert y_r[0].shape[0] == y_g[0].shape[0] == 4 and y_r[2].shape[0] == 2
    torch.testing.assert_close(y_r[0][:2], y_r[0][2:], rtol=0, atol=0)
    assert f_r[1][0].shape == f_g[1][0].shape


def test_discriminator_weight_round_trip_is_exact(flagship_disc):
    """flax params -> port state dict -> vits_tpu's convert_discriminator ->
    the same flax params, and back: bit for bit, key for key."""
    _, params, td, _, _ = flagship_disc
    sd = td.state_dict()
    assert all(k.startswith(("combd.blocks.", "sbd.discriminators.")) for k in sd)
    back = C.convert_discriminator(sd)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, v in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(v),
                                      err_msg=jax.tree_util.keystr(path))
    again = flax_to_state_dict(td, back)
    assert set(again) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(again[k]), v.numpy(), err_msg=k)


def test_dense_grouped_is_accepted_and_computes_the_grouped_conv(probe_disc):
    _, params, td, y, ys_hat = probe_disc
    cfg = dataclasses.replace(t_avocodo.COMBD_PROBE, dense_grouped=True)
    dense = load_flax_params(
        t_avocodo.AvocodoDiscriminator(cfg, t_avocodo.SBD_PROBE, segment_size=2048,
                                       device="cpu"), params).eval()
    with torch.no_grad():
        a = td(_t(y), [_t(v) for v in ys_hat])
        b = dense(_t(y), [_t(v) for v in ys_hat])
    for x, z in zip(jax.tree_util.tree_leaves(a[0]), jax.tree_util.tree_leaves(b[0])):
        torch.testing.assert_close(x, z, rtol=0, atol=0)


# -- the bf16 policy, module by module -------------------------------------------------------


def _within_twice_the_jax_gap(port_bf16, jax_bf16, jax_f32, what):
    """|port bf16 - JAX bf16| <= 2 * |JAX bf16 - JAX f32| (max norms)."""
    jb = np.asarray(jax_bf16, np.float32)
    gap = np.abs(jb - np.asarray(jax_f32, np.float32)).max()
    err = np.abs(np.asarray(port_bf16, np.float32) - jb).max()
    assert gap > 0, f"{what}: the JAX bf16 run equals its f32 run"
    assert err <= 2 * gap, f"{what}: port bf16 off JAX bf16 by {err}, JAX's own gap {gap}"


def test_posterior_encoder_bf16_parity():
    rng = np.random.default_rng(35)
    x = np.abs(rng.standard_normal((2, 11, 20))).astype(np.float32)
    lengths = np.array([11, 7])
    g = rng.standard_normal((2, 1, 6)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    j32 = j_posterior.PosteriorEncoder(20, 5, 8, 5, 1, 3, gin_channels=6)
    jbf = j_posterior.PosteriorEncoder(20, 5, 8, 5, 1, 3, gin_channels=6, bf16=True)
    params = perturb_zeros(j32.init(jax.random.PRNGKey(0), x, lengths, g, key), 4)
    ref32, refbf = j32.apply(params, x, lengths, g, key), jbf.apply(params, x, lengths, g, key)
    eps = np.asarray(jax.random.normal(key, (2, 11, 5)))
    tm = load_flax_params(
        t_posterior.PosteriorEncoder(20, 5, 8, 5, 1, 3, gin_channels=6, bf16=True), params
    ).eval()
    out = tm(to_torch(x, True), to_torch(lengths), to_torch(g, True), to_torch(eps, True))
    for name, r32, rbf, o in zip(("z", "m", "logs"), ref32, refbf, out):
        assert o.dtype == torch.float32 and np.asarray(rbf).dtype == np.float32
        _within_twice_the_jax_gap(from_torch(o, True), rbf, r32, name)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_hifigan_bf16_parity():
    rng = np.random.default_rng(36)
    x = rng.standard_normal((2, 6, 10)).astype(np.float32)
    g = rng.standard_normal((2, 1, 4)).astype(np.float32)
    args = ("1", (3, 5), ((1, 3), (1, 3)), (4, 2, 2, 2), 16, (8, 4, 4, 4))
    hier = j_hifigan.HiFiGANGenerator.hier_forward
    j32 = j_hifigan.HiFiGANGenerator(10, *args, gin_channels=4)
    jbf = j_hifigan.HiFiGANGenerator(10, *args, gin_channels=4, bf16=True)
    params = jax.jit(lambda k: j32.init(k, x, g, method=hier))(jax.random.PRNGKey(0))
    ref32 = jax.jit(lambda p: j32.apply(p, x, g, method=hier))(params)
    refbf = jax.jit(lambda p: jbf.apply(p, x, g, method=hier))(params)
    tm = load_flax_params(t_hifigan.HiFiGANGenerator(10, *args, gin_channels=4, bf16=True),
                          params).eval()
    with torch.no_grad():
        outs = tm.hier_forward(to_torch(x, True), to_torch(g, True))
    for i, (r32, rbf, o) in enumerate(zip(ref32, refbf, outs)):
        assert o.dtype == torch.float32 and rbf.dtype == jnp.float32
        _within_twice_the_jax_gap(from_torch(o, True), rbf, r32, f"scale {i}")


def test_discriminator_bf16_parity(probe_disc):
    jd, params, _, y, ys_hat = probe_disc
    jbf = j_avocodo.AvocodoDiscriminator(combd_cfg=j_avocodo.COMBD_PROBE,
                                         sbd_cfg=j_avocodo.SBD_PROBE, bf16=True)
    ref32 = jax.jit(jd.apply)(params, y, ys_hat)
    refbf = jax.jit(jbf.apply)(params, y, ys_hat)
    tbf = load_flax_params(
        t_avocodo.AvocodoDiscriminator(t_avocodo.COMBD_PROBE, t_avocodo.SBD_PROBE, bf16=True,
                                       segment_size=2048, device="cpu"), params).eval()
    with torch.no_grad():
        out = tbf(_t(y), [_t(a) for a in ys_hat])
    assert out[0][0].dtype == torch.bfloat16
    names = ("real logits", "generated logits", "real fmaps", "generated fmaps")
    for name, a32, abf, o in zip(names, ref32, refbf, out):
        flat = [x for v in o for x in (v if isinstance(v, list) else [v])]
        for i, (r32, rbf, x) in enumerate(zip(jax.tree_util.tree_leaves(a32),
                                              jax.tree_util.tree_leaves(abf), flat)):
            _within_twice_the_jax_gap(x.float().numpy(), rbf, r32, f"{name} {i}")
    loss = t_losses.discriminator_loss(out[0], out[1])[0]
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
