"""``tools/convergence_torch.py`` (the port's convergence study) against the
JAX tool ``tools/convergence_v2.py`` on the CPU: the corpus byte for byte
from the same seed, the copied symbol decoder and edit distance on fixed
inputs, and a one-epoch train -> analyze -> synth at a tiny configuration
(``tests/test_train_loop.py``'s model with the probe discriminator), whose
metrics must be finite.
"""

import filecmp
import importlib.util
import json
import logging
import os
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile

from tests.test_train_loop import TINY_CONFIG

ROOT = Path(__file__).resolve().parent.parent
N_TRAIN, N_VAL, N_HELDOUT = 4, 2, 2


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PORT = _tool("convergence_torch")
JAX = _tool("convergence_v2")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Both tools' corpora written to the same path (the file lists name
    it), one after the other: (JAX's copy, the port's)."""
    root = tmp_path_factory.mktemp("conv")
    work = root / "w"
    JAX.gen(str(work), n_train=N_TRAIN, n_val=N_VAL, n_heldout=N_HELDOUT)
    work.rename(root / "jax")
    PORT.gen(str(work), n_train=N_TRAIN, n_val=N_VAL, n_heldout=N_HELDOUT)
    return root / "jax", work


def test_gen_writes_the_jax_corpus_byte_for_byte(corpora):
    jax_dir, port_dir = corpora
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    assert len([n for n in names if n.endswith(".wav")]) == N_TRAIN + N_VAL + N_HELDOUT
    _, mismatch, errors = filecmp.cmpfiles(jax_dir, port_dir, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_tables_are_the_jax_tables():
    assert PORT.SYMS == JAX.SYMS and PORT.F0S == JAX.F0S and PORT.DURS == JAX.DURS
    assert (PORT.SR, PORT.HOP) == (JAX.SR, JAX.HOP)


def test_symbol_decoder_matches_jax(corpora):
    """On the ground-truth utterances and on noise, the same symbols and
    run lengths; on the corpus they recover the written text."""
    _, port_dir = corpora
    gt = json.loads((port_dir / "gt.json").read_text())
    for name, entry in gt.items():
        _, audio = scipy.io.wavfile.read(port_dir / name)
        audio = audio.astype(np.float64) / 24000
        got = PORT._decode_symbols(audio)
        assert got == JAX._decode_symbols(audio), name
        assert "".join(got[0]) == entry["text"], name
    noise = np.random.default_rng(3).standard_normal(30 * PORT.HOP) * 0.3
    assert PORT._decode_symbols(noise) == JAX._decode_symbols(noise)


@pytest.mark.parametrize("a,b", [("", ""), ("abc", ""), ("kitten", "sitting"),
                                 ("aeiou", "uoiea"), ("konaulaos", "konaulaos"),
                                 ("ksm", "ksmnl")])
def test_levenshtein_matches_jax(a, b):
    assert PORT._levenshtein(list(a), list(b)) == JAX._levenshtein(list(a), list(b))


@pytest.fixture(scope="module")
def tiny_study(corpora):
    """gen'd corpus -> one epoch of the 4 voices at batch 2 (3 steps: the
    bucket sampler pads its buckets) with an evaluation and a checkpoint at
    step 2 -> analyze -> synth, on the CPU."""
    _, work = corpora
    model = dict(TINY_CONFIG["model"])
    cfg = PORT.make_config(str(work), 1, model=model, train={
        "batch_size": 2, "eval_interval": 2, "save_interval": 2, "log_interval": 1,
        "segment_size": 2048, "bf16_run": False})
    report = PORT.train(str(work), 1, device="cpu", config=cfg)
    # The run's logger is process-wide, named by its directory ("run"), and
    # keeps writing this run's train.log: a later run in this process under
    # a directory of that name (tests/test_train_loop.py's) would find the
    # handler set and write no train.log of its own. Close it.
    logger = logging.getLogger("run")
    for handler in logger.handlers[:]:
        logger.removeHandler(handler)
        handler.close()
    rows = PORT.analyze(str(work), device="cpu")
    summary = PORT.synth(str(work), device="cpu")
    return work, report, rows, summary


def test_make_config_is_the_jax_study_config(tmp_path):
    import yaml

    port = yaml.safe_load(Path(PORT.make_config(str(tmp_path), 250)).read_text())
    cwd = os.getcwd()
    os.chdir(ROOT)  # the JAX tool reads configs/ from the working directory
    try:
        jax_cfg = yaml.safe_load(Path(JAX.make_config(str(tmp_path), 250)).read_text())
    finally:
        os.chdir(cwd)
    assert port == jax_cfg
    assert port["train"]["batch_size"] == 16 and port["train"]["bf16_run"] is True
    assert port["model"]["upsample_initial_channel"] == 256 and port["model"]["n_layers"] == 4


def test_tiny_study_trains_analyzes_and_synthesizes(tiny_study):
    work, report, rows, summary = tiny_study
    assert report.state.step == 3
    assert all(np.isfinite(list(report.last_metrics.values())))
    assert [r["step"] for r in rows] == [2]
    for key in ("dur_loss", "mas_frame_acc", "mas_boundary_mae"):
        assert np.isfinite(rows[0][key]), key
    assert 0 <= rows[0]["mas_frame_acc"] <= 1
    assert all(r is None or np.isfinite(r) for r in (rows[0]["r_mas"], rows[0]["r_sdp"]))
    assert json.loads((work / "analysis.json").read_text()) == rows
    assert summary["n"] == N_HELDOUT and 0 <= summary["exact_order"] <= N_HELDOUT
    assert np.isfinite(summary["mean_sim"])
    assert json.loads((work / "synth_check.json").read_text())["summary"] == summary
