"""The port's migration of reference (Aloento/VITS) checkpoints,
``vits_torch/utils/convert_reference.py``, against the JAX package's
``vits_tpu/utils/convert_torch.py`` on the CPU, at
``tests/test_torch_serve.py``'s CFG (the reference's fixed depths: 16
posterior layers, 4 flows; narrow widths).

- Which keys: the port takes exactly the entries the JAX converter reads,
  for the generator at several depths and for the flagship discriminator.
  Both converters copy the payload into a plain dict of their own before
  reading it, so the reads are recorded by the payload's values
  (``_Read.detach``, which the JAX converter's ``_np`` and the port's copy
  both call), not by a logging dict.
- A ``Model_Eval_4242.pth`` with ``module.`` prefixes and entries neither
  converter reads becomes ``eval_4242``, equal to the source tensors bit for
  bit; served by the port's engine it is held to the JAX engine serving the
  same pair through ``vits_tpu.utils.convert_torch.convert_checkpoint_file``
  at rtol/atol 1e-4 (XLA and PyTorch sum f32 in other orders, as in
  ``tests/test_torch_serve.py``), the decoder's gains raised (x24) so the
  audio has signal. The JAX file converter reads the architecture off the
  keys before it strips ``module.`` (``convert_torch.py:299``), so it sizes a
  DDP payload as 0 layers and 0 upsamplings; the JAX engine therefore serves
  the pair's unprefixed form, and the port, which reads the architecture
  after stripping, converts both forms to the same file.
- ``disc_4242`` merges into a fresh flagship D whole and equals the JAX
  converter's tree loaded through ``convert_jax.load_flax_params``.
- Missing keys raise ``KeyError`` in both packages; the step comes from the
  file name unless ``--step`` says otherwise; the CLI prints the path.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import yaml

from vits_tpu.serve.engine import TTSEngine as JaxEngine
from vits_tpu.utils import convert_torch as jct

from vits_torch.config import HParams
from vits_torch.models.avocodo import AvocodoDiscriminator
from vits_torch.models.synthesizer import build_synthesizer
from vits_torch.serve.engine import TTSEngine
from vits_torch.training import checkpoint as ckpt
from vits_torch.utils import convert_reference as cr
from vits_torch.utils.convert_jax import load_flax_params

from tests._torch_ranks import subprocess_env
from tests.test_torch_modules import perturb_zeros
from tests.test_torch_serve import CFG, _scale_gains, jax_noise

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
STEP = 4242
# (text-encoder layers, MRF kernel sizes, dilations): the CFG's own first
DEPTHS = {
    "1 layer, 1 kernel": (1, [3], [[1, 3]]),
    "2 layers, 1 kernel": (2, [3], [[1, 3]]),
    "1 layer, 3 kernels": (1, [3, 5, 7], [[1, 3, 5]] * 3),
    "2 layers, 3 kernels": (2, [3, 5, 7], [[1, 3, 5]] * 3),
}
# entries neither converter reads: one in the generator, the reference
# Avocodo's PQMF filter buffers in the discriminator
G_EXTRA = {"unread_buffer": torch.arange(5.0)}
D_EXTRA = {"combd.pqmf_list.0.analysis_filter": torch.ones(4, 1, 193),
           "sbd.pqmf.analysis_filter": torch.ones(16, 1, 257)}


def _hps(depth="1 layer, 1 kernel"):
    n_layers, kernels, dilations = DEPTHS[depth]
    model = dict(CFG["model"], n_layers=n_layers, resblock_kernel_sizes=kernels,
                 resblock_dilation_sizes=dilations)
    return HParams(**dict(CFG, model=model))


def _generator_sd(depth="1 layer, 1 kernel", seed=0):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return build_synthesizer(_hps(depth), device="cpu").state_dict()


def _discriminator_sd(seed=0):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return AvocodoDiscriminator(segment_size=2048, device="cpu").state_dict()


def _payload(sd, extra, prefix="module."):
    return {prefix + k: v for k, v in {**sd, **extra}.items()}


class _Read:
    """A payload value that records its key when a converter reads it."""

    def __init__(self, key, value, log):
        self.key, self.value, self.log = key, value, log

    def detach(self):
        self.log.add(self.key)
        return self.value.detach()


def _reads(convert, payload) -> set[str]:
    """The payload keys ``convert`` reads."""
    log = set()
    convert({k: _Read(k, v, log) for k, v in payload.items()})
    return log


def _strip(keys):
    return {k.replace("module.", "", 1) for k in keys}


# ---- (a) which keys -------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
def test_generator_keys_are_the_keys_jax_reads(depth):
    payload = _payload(_generator_sd(depth), G_EXTRA)
    arch = jct._detect_arch(cr._strip_module(payload))
    jax_read = _reads(lambda sd: jct.convert_synthesizer(sd, **arch), payload)
    port_read = _reads(lambda sd: cr.convert_synthesizer(sd, **arch), payload)
    assert port_read == jax_read
    assert cr.synthesizer_keys(payload, **arch) == _strip(jax_read) == set(_generator_sd(depth))
    assert set(cr.convert_synthesizer(payload, **arch)) == _strip(jax_read)


def test_discriminator_keys_are_the_keys_jax_reads():
    payload = _payload(_discriminator_sd(), D_EXTRA)
    jax_read = _reads(jct.convert_discriminator, payload)
    assert _reads(cr.convert_discriminator, payload) == jax_read
    assert cr.discriminator_keys(payload) == _strip(jax_read) == set(_discriminator_sd())
    assert set(cr.convert_discriminator(payload)) == _strip(jax_read)


# ---- (b) architecture detection ---------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
def test_detect_arch_as_jax(depth):
    n_layers, kernels, dilations = DEPTHS[depth]
    sd = _payload(_generator_sd(depth), G_EXTRA, prefix="")
    want = dict(n_layers_text=n_layers, n_ups=4, n_kernels=len(kernels),
                resblock_convs=len(dilations[0]))
    assert cr._detect_arch(sd) == jct._detect_arch(sd) == want
    ddp = _payload(_generator_sd(depth), G_EXTRA)  # keys start "module.": nothing matches
    assert cr._detect_arch(ddp) == jct._detect_arch(ddp)
    assert cr._detect_arch(cr._strip_module(ddp)) == want


# ---- (c) module. stripping ------------------------------------------------


@pytest.mark.parametrize("prefix", ["", "module.", "module.module."])
def test_strip_module_as_jax(prefix):
    """One ``module.`` goes, as in the JAX converter: a payload wrapped
    twice is read by neither package."""
    payload = _payload(_discriminator_sd(), D_EXTRA, prefix)
    outcomes = []
    for convert in (jct.convert_discriminator, cr.convert_discriminator):
        try:
            outcomes.append(_reads(convert, payload))
        except KeyError as e:
            outcomes.append(type(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is KeyError) == (prefix == "module.module.")


@pytest.mark.parametrize("key", ["module.a.b", "a.module.b", "module.module.a", "a", "modules.a"])
def test_strip_module_takes_the_first_occurrence(key):
    assert list(cr._strip_module({key: 0})) == [key.replace("module.", "", 1)]


# ---- (d) a .pth pair end to end ---------------------------------------------


@pytest.fixture(scope="module")
def migrated(tmp_path_factory):
    """A reference pair in its DDP (``module.``) form and its plain form,
    converted by the port (DDP form) and by the JAX package (plain form)."""
    root = tmp_path_factory.mktemp("migrate")
    cfg = root / "config.yaml"
    cfg.write_text(yaml.safe_dump(CFG))
    g = _generator_sd()
    model = build_synthesizer(_hps(), device="cpu")
    params = perturb_zeros(jct.convert_synthesizer(g, n_layers_text=1, n_kernels=1,
                                                   resblock_convs=2), seed=3)["params"]
    params["waveform_decoder"] = _scale_gains(params["waveform_decoder"])
    load_flax_params(model, {"params": params})
    g = {k: v.clone() for k, v in model.state_dict().items()}
    d = _discriminator_sd()
    paths = {}
    for form, prefix in (("ddp", "module."), ("plain", "")):
        (root / form).mkdir()
        gp, dp = _payload(g, G_EXTRA, prefix), _payload(d, D_EXTRA, prefix)
        if form == "ddp":  # every tensor a view of one storage, as a flat-buffer save
            flat = torch.cat([v.flatten().float() for v in gp.values()])
            views, at = {}, 0
            for k, v in gp.items():
                views[k] = flat[at:at + v.numel()].view(v.shape).to(v.dtype)
                at += v.numel()
            gp = views
        opt = torch.optim.AdamW([torch.zeros(3, requires_grad=True)], lr=2e-4).state_dict()
        paths[form] = (root / form / f"Model_Eval_{STEP}.pth", root / form / f"Model_Train_{STEP}.pth")
        torch.save({"model_g": gp, "iteration": STEP, "learning_rate": 2e-4}, paths[form][0])
        torch.save({"model_d": dp, "optimizer": opt, "iteration": STEP}, paths[form][1])
    port = cr.convert_checkpoint_file(str(paths["ddp"][0]), str(root / "port"),
                                      train_pth=str(paths["ddp"][1]))
    jax_eval = jct.convert_checkpoint_file(str(paths["plain"][0]), str(root / "jax"),
                                           train_pth=str(paths["plain"][1]))
    return dict(root=root, cfg=str(cfg), g=g, d=d, paths=paths, port=port, jax=jax_eval)


@pytest.fixture(scope="module")
def served(migrated):
    jeng = JaxEngine(migrated["cfg"], checkpoint_path=migrated["jax"], max_frames=96)
    port = TTSEngine(migrated["cfg"], checkpoint_path=migrated["port"], max_frames=96,
                     device="cpu", noise_fn=jax_noise)
    return jeng, port


def _assert_equal_sd(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_converted_eval_is_the_source_bit_for_bit(migrated):
    assert os.path.basename(migrated["port"]) == f"eval_{STEP}"
    payload = torch.load(migrated["port"], weights_only=True)
    assert list(payload) == ["g_params"]
    _assert_equal_sd(payload["g_params"], migrated["g"])
    # each tensor owns its storage: the payload's views were not saved whole
    for k, v in payload["g_params"].items():
        assert v.untyped_storage().nbytes() == v.numel() * v.element_size(), k


def test_ddp_and_plain_payloads_convert_alike(migrated, tmp_path):
    plain = cr.convert_checkpoint_file(str(migrated["paths"]["plain"][0]), str(tmp_path))
    _assert_equal_sd(ckpt.load_eval_params(plain), ckpt.load_eval_params(migrated["port"]))
    ddp = torch.load(migrated["paths"]["ddp"][0], weights_only=True)["model_g"]
    assert set(jct._detect_arch(ddp).values()) == {0}  # the JAX file converter's sizes


@pytest.mark.parametrize("text,speaker,seed", [
    ("[P]ni3#hao3 shi4#jie4[P]", 0, 1),
    ("[ZH]今天[ZH][EN]good morning[EN][JA]ありがとう[JA]", 1, 2),
])
def test_migrated_pair_serves_as_the_jax_engine(served, text, speaker, seed):
    jeng, port = served
    ref = jeng.synthesize(text, speaker, seed)
    out = port.synthesize(text, speaker, seed)
    assert out[0] == ref[0]
    a, r = out[1][1], ref[1][1]
    assert a.shape == r.shape and np.abs(r).max() > 0.05  # audio with signal
    np.testing.assert_allclose(a, r, **TOL)


def test_migrated_pair_voice_conversion_as_the_jax_engine(served):
    """VC runs the posterior encoders: the whole generator was taken."""
    jeng, port = served
    rng = np.random.default_rng(4)
    t = np.arange(6000) / 22050
    wav = (0.3 * np.sin(2 * np.pi * 150 * t) + 0.01 * rng.standard_normal(6000)).astype(np.float32)
    np.testing.assert_allclose(port.voice_conversion(wav, 0, 1, seed=3),
                               jeng.voice_conversion(wav, 0, 1, seed=3), **TOL)


# ---- (e) the discriminator --------------------------------------------------


def test_disc_merges_whole_into_a_fresh_flagship(migrated):
    path = os.path.join(os.path.dirname(migrated["port"]), f"disc_{STEP}")
    payload = torch.load(path, weights_only=True)
    assert list(payload) == ["d_params"]  # no optimizer moments
    with torch.random.fork_rng():
        torch.manual_seed(9)
        disc = AvocodoDiscriminator(segment_size=2048, device="cpu")
    merged, used, skipped = ckpt.merge_compatible(disc.state_dict(), payload["d_params"])
    assert (used, skipped) == (len(disc.state_dict()), 0)
    disc.load_state_dict(merged)
    _assert_equal_sd(disc.state_dict(), migrated["d"])


def test_disc_equals_the_jax_tree(migrated):
    path = os.path.join(os.path.dirname(migrated["jax"]), f"disc_{STEP}")
    tree = ocp.StandardCheckpointer().restore(path)["d_params"]
    with torch.random.fork_rng():
        torch.manual_seed(9)
        disc = AvocodoDiscriminator(segment_size=2048, device="cpu")
    load_flax_params(disc, {"params": tree})
    port = torch.load(os.path.join(os.path.dirname(migrated["port"]), f"disc_{STEP}"),
                      weights_only=True)
    _assert_equal_sd(port["d_params"], disc.state_dict())


# ---- (f) errors and the command line ----------------------------------------


@pytest.mark.parametrize("drop", [
    "emb_g.weight",  # a model without speaker embedding
    "posterior_encoder.enc.in_layers.15.weight_v",  # 15 posterior layers
    "flow.flows.6.post.weight",  # 3 flows
])
def test_missing_generator_key_raises_in_both(drop, tmp_path):
    payload = _payload(_generator_sd(), G_EXTRA)
    del payload["module." + drop]
    arch = cr._detect_arch(cr._strip_module(payload))
    with pytest.raises(KeyError, match=drop.replace(".", r"\.")):
        jct.convert_synthesizer(payload, **arch)
    with pytest.raises(KeyError, match=drop.replace(".", r"\.")):
        cr.convert_synthesizer(payload, **arch)
    pth = tmp_path / f"Model_Eval_{STEP}.pth"
    torch.save({"model_g": payload}, pth)
    with pytest.raises(KeyError):
        cr.convert_checkpoint_file(str(pth), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_missing_discriminator_key_raises_in_both():
    payload = _payload(_discriminator_sd(), D_EXTRA)
    del payload["module.sbd.discriminators.3.convs.4.d_convs.2.weight_g"]
    for convert in (jct.convert_discriminator, cr.convert_discriminator):
        with pytest.raises(KeyError, match="sbd.discriminators.3.convs.4.d_convs.2.weight_g"):
            convert(payload)


@pytest.mark.parametrize("wrap", ["model_g", "model", "bare"])
def test_payload_forms(migrated, wrap, tmp_path):
    """The generator under ``model_g``, ``model`` or bare, as the JAX file
    converter takes it."""
    sd = _payload(migrated["g"], G_EXTRA)
    pth = tmp_path / f"G_{STEP}.pth"
    torch.save(sd if wrap == "bare" else {wrap: sd}, pth)
    out = cr.convert_checkpoint_file(str(pth), str(tmp_path))
    _assert_equal_sd(ckpt.load_eval_params(out), migrated["g"])


@pytest.mark.parametrize("argv,name", [
    ([], f"eval_{STEP}"),
    (["--step", "7"], "eval_7"),
])
def test_main_prints_and_returns_the_path(migrated, argv, name, tmp_path, capsys):
    eval_pth, train_pth = (str(p) for p in migrated["paths"]["ddp"])
    out = cr.main([eval_pth, "--out-dir", str(tmp_path), "--train-pth", train_pth, *argv])
    assert out == str(tmp_path / name)
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {out}"
    disc = name.replace("eval", "disc")
    assert sorted(os.listdir(tmp_path)) == [disc, name]
    _assert_equal_sd(ckpt.load_eval_params(out), migrated["g"])


def test_step_from_the_last_digits_of_the_name(migrated, tmp_path):
    pth = tmp_path / "run3_G_12_Eval_300.pth"
    pth.write_bytes(migrated["paths"]["plain"][0].read_bytes())
    assert os.path.basename(cr.convert_checkpoint_file(str(pth), str(tmp_path))) == "eval_300"
    pth = tmp_path / "generator.pth"
    pth.write_bytes(migrated["paths"]["plain"][0].read_bytes())
    assert os.path.basename(cr.convert_checkpoint_file(str(pth), str(tmp_path))) == "eval_0"


def test_module_runs_as_a_command(migrated, tmp_path):
    eval_pth, train_pth = (str(p) for p in migrated["paths"]["ddp"])
    proc = subprocess.run(
        [sys.executable, "-m", "vits_torch.utils.convert_reference", eval_pth,
         "--out-dir", str(tmp_path), "--train-pth", train_pth],
        cwd=ROOT, env=subprocess_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == f"wrote {tmp_path / f'eval_{STEP}'}"
    assert "dropped 1" in proc.stderr and "dropped 2" in proc.stderr  # the extra entries
    _assert_equal_sd(ckpt.load_eval_params(str(tmp_path / f"eval_{STEP}")), migrated["g"])
