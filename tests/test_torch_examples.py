"""The port's examples (``examples/*_torch.py``) at their smallest settings
on the CPU: the quickstart trains 2 steps of its test-sized model on 4
synthetic voices and serves what it saved; the batched-serving example
answers 6 requests through the DynamicBatcher at the tiny serving
configuration of ``tests/test_torch_serve.py``."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import yaml

from tests._torch_ranks import subprocess_env
from tests.test_torch_serve import CFG as TINY_SERVE_CFG

ROOT = Path(__file__).resolve().parent.parent


def _run(args, cwd=ROOT, timeout=300):
    proc = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_trains_and_serves_on_the_cpu(tmp_path):
    out = _run(["examples/quickstart_synthetic_torch.py", "--workdir", str(tmp_path / "qs"),
                "--tiny", "--utts", "4", "--epochs", "1", "--batch-size", "2",
                "--device", "cpu"])
    lines = out.splitlines()
    assert lines[0].startswith("trained steps 1-2: loss/g/total "), out
    f0s = [float(ln.split("f0=")[1].split(" Hz")[0]) for ln in lines if "f0=" in ln]
    assert len(f0s) == 4 and all(60 <= f <= 500 for f in f0s), out
    assert any(ln.startswith("pitch identity (speaker 1 above speaker 0): ") for ln in lines)
    names = {p.name for p in (tmp_path / "qs" / "run").iterdir()}
    assert {"eval_2", "train_2", "train.log", "config.yaml"} <= names
    for spk in (0, 1):
        wav = tmp_path / "qs" / f"spk{spk}.wav"
        assert wav.stat().st_size > 44


def test_serve_batched_answers_every_request_on_the_cpu(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_SERVE_CFG, allow_unicode=True))
    out = _run(["examples/serve_batched_torch.py", "--config", str(cfg), "--requests", "6",
                "--max-batch", "3", "--max-frames", "96", "--device", "cpu"])
    line = out.strip().splitlines()[-1]
    assert line.startswith("6 requests in ") and line.endswith("(cpu)"), out
    assert np.isfinite(float(line.split("= ")[1].split(" req/s")[0]))
