"""The port's train CLI under torchrun with ``--distributed`` over 2 gloo
ranks on the CPU (``tests/test_torch_graft_dryrun.py`` holds the other
entry points: a refused global batch, ``vits_torch.graft_entry``'s
``dryrun_multichip`` and ``entry``).

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

from vits_torch.config import load_hparams
from vits_torch.serve.engine import TTSEngine
from vits_torch.training.checkpoint import load_checkpoint
from vits_torch.training.step import create_train_state
from vits_torch.training.train import build_discriminator
from vits_torch.models.synthesizer import build_synthesizer

from chip_smoke import processes_naming
from tests._torch_ranks import subprocess_env
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
                          env=subprocess_env())


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
