"""The port's entry points on the CPU beside the training run of
``tests/test_torch_graft_entry.py``: the train CLI under torchrun refusing a
global batch the ranks cannot split, ``vits_torch.graft_entry``'s
``dryrun_multichip`` (through its command line) and ``entry``, and both
running on the card by default. Kept apart from that file so that neither
sets the suite's tail alone under ``--dist loadfile``.
"""

import numpy as np
import pytest
import torch

from vits_torch import graft_entry

from tests.test_torch_graft_entry import _torchrun
from tests.test_torch_train_loop import _config, _write_data


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

