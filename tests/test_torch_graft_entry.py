"""The port's entry points on the CPU: the train CLI under torchrun
with ``--distributed`` over 2 gloo ranks, ``vits_torch.graft_entry``'s
``dryrun_multichip`` (through its command line) and ``entry``.

The CLI runs ``tests/test_train_loop.py``'s TINY_CONFIG (global batch 2, one
row a rank) on 4 voices: 2 steps with an evaluation and a checkpoint at step
2, then resumed to 2 epochs (steps 3-6: the saved epoch runs again, as in one
process). Rank 0 alone writes the run's files; the checkpoints load strictly
into the port's TTSEngine and TrainState; no process of the run (torchrun's
agent, the ranks, their loader workers) outlives it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vits_torch import graft_entry
from vits_torch.config import load_hparams
from vits_torch.serve.engine import TTSEngine
from vits_torch.training.checkpoint import load_checkpoint
from vits_torch.training.step import create_train_state
from vits_torch.training.train import build_discriminator
from vits_torch.models.synthesizer import build_synthesizer

from chip_smoke import processes_naming
from tests.test_torch_train_loop import _config, _write_data

ROOT = Path(__file__).resolve().parent.parent


def _torchrun(cfg, model_dir, nproc=2):
    # the ranks meet on the loopback device (--local-addr, GLOO_SOCKET_IFNAME)
    # whatever the host's name resolves to
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--local-addr", "127.0.0.1", f"--nproc_per_node={nproc}", "-m",
           "vits_torch.training.train", "-c", cfg, "-m", model_dir, "--distributed",
           "--device", "cpu"]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"})


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp_cli")
    lines = _write_data(d, [48, 40, 44, 36])
    (d / "train.csv").write_text("\n".join(lines), encoding="utf-8")
    (d / "val.csv").write_text("\n".join(lines[:2]), encoding="utf-8")
    model_dir = str(d / "run")
    runs = []
    for epochs in (1, 2):
        runs.append(_torchrun(_config(d, train={"epochs": epochs}), model_dir))
        runs[-1].left = processes_naming(model_dir)
    return d, model_dir, runs


def test_cli_runs_and_leaves_no_process(cli_run):
    _, model_dir, runs = cli_run
    for proc in runs:
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.left == {}


def test_cli_rank_0_alone_writes_the_run(cli_run):
    _, model_dir, _ = cli_run
    names = sorted(os.listdir(model_dir))
    assert [n for n in names if n.startswith(("train_", "eval_"))] == \
        ["eval_4", "eval_6", "train_4", "train_6"]  # keep_ckpts 2
    log = (Path(model_dir) / "train.log").read_text()
    # one line a run: only rank 0 writes train.log
    assert log.count("data parallel over 2 process(es) (cpu), global batch 2") == 2
    assert log.count("run done at step") == 2
    for step in range(1, 7):
        assert log.count(f"step {step} | g ") == 1
    assert f"resumed from {model_dir}/train_2 (epoch 0)" in log
    assert log.count("saved checkpoint at step") == 3


def test_cli_checkpoints_load_strictly(cli_run):
    _, model_dir, _ = cli_run
    cfg = str(Path(model_dir) / "config.yaml")
    eng = TTSEngine(cfg, checkpoint_path=str(Path(model_dir) / "eval_6"), max_frames=96,
                    device="cpu")
    _, (rate, audio) = eng.synthesize("[P]ni3#hao3[P]", 1, seed=0)
    assert rate == 22050 and audio.ndim == 1 and len(audio) > 0 and np.isfinite(audio).all()
    hps = load_hparams(cfg)
    state = create_train_state(build_synthesizer(hps, device="cpu"),
                               build_discriminator(hps, False, "cpu"), hps, steps_per_epoch=2)
    state, epoch = load_checkpoint(str(Path(model_dir) / "train_6"), state)
    assert (state.step, epoch) == (6, 1)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, eng.model.state_dict()[k]), k


def test_distributed_cli_needs_divisible_global_batch(tmp_path):
    """The global batch must split evenly over the ranks (the JAX message)."""
    lines = _write_data(tmp_path, [48, 40])
    (tmp_path / "train.csv").write_text("\n".join(lines), encoding="utf-8")
    (tmp_path / "val.csv").write_text("\n".join(lines), encoding="utf-8")
    proc = _torchrun(_config(tmp_path, train={"batch_size": 3}), str(tmp_path / "run"))
    assert proc.returncode != 0
    assert "global batch 3 not divisible by process count 2" in proc.stderr


def test_dryrun_multichip_two_ranks(capsys):
    metrics = graft_entry.main(["2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == (f"dryrun_multichip(2): ok, loss/g/total={metrics['loss/g/total']:.3f} "
                       f"loss/d/total={metrics['loss/d/total']:.3f}")
    assert np.isfinite(list(metrics.values())).all()


def test_entry_synthesizes_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    model = args[0]
    assert model.device.type == "cpu" and sum(p.numel() for p in model.parameters()) > 3e7
    wav = fn(*args)
    assert tuple(wav.shape) == (1, 256 * 256, 1) and torch.isfinite(wav).all()


def test_entry_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()


def test_dryrun_multichip_runs_on_the_card_by_default():
    """Without ``device`` the ranks go to the cards: with none, it raises
    before it starts a process."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multichip(2)

