"""Quickstart for the PyTorch/CUDA port: train vits_torch end to end on a
synthetic 2-speaker corpus (the corpus of examples/quickstart_synthetic.py).

Generates harmonic "speech" with per-speaker f0 (120 / 200 Hz), trains for
``--epochs`` epochs on the card (``--device cpu`` for the CPU), then
synthesizes both speakers with the port's TTSEngine from the newest
``eval_{step}`` and prints the learned pitch of each and of two PITS scope
shifts.

    python examples/quickstart_synthetic_torch.py --workdir <dir> --epochs 500
    python examples/quickstart_synthetic_torch.py --workdir <dir> --tiny \\
        --utts 4 --epochs 1 --device cpu        # smoke run, test-sized model

Not measured on a card yet: how many epochs give speaker-distinct pitch.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import scipy.io.wavfile
import yaml

# allow running as a plain script from the repo root without pip install -e
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# tests/test_train_loop.py's tiny model, with the probe discriminator
TINY_MODEL = dict(
    inter_channels=96, hidden_channels=48, filter_channels=64, n_heads=2, n_layers=1,
    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], upsample_initial_channel=32,
    posterior_layers=2, flow_n_flows=1, flow_wn_layers=1, dur_n_flows=1, yin_dec_layers=2,
    discriminator_size="probe",
)


def make_dataset(workdir: str, n_utts: int = 64, sr: int = 22050):
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(0)
    f0s = {0: 120.0, 1: 200.0}
    text = "ni→xɑʊ↓↑ ni→xɑʊ↓↑"
    lang = " ".join(["0"] * len(text))
    lines = []
    for i in range(n_utts):
        spk = i % 2
        n = int(1.5 * sr)
        tgrid = np.arange(n) / sr
        f0 = f0s[spk] * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * tgrid + i))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        sig = 0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase) + 0.1 * np.sin(3 * phase)
        env = 0.5 * (1 + np.sin(2 * np.pi * 2.5 * tgrid + i * 0.3))
        sig = sig * env + 0.01 * rng.standard_normal(n)
        path = os.path.join(workdir, f"utt{i:03d}.wav")
        scipy.io.wavfile.write(path, sr, (np.clip(sig, -1, 1) * 20000).astype(np.int16))
        lines.append(f"{path}|S{spk}|{text}|{lang}")
    with open(os.path.join(workdir, "train.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(workdir, "val.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines[:4]) + "\n")


def make_config(workdir: str, epochs: int, n_utts: int, batch_size: int, tiny: bool) -> str:
    with open(os.path.join(ROOT, "configs", "config_cje.yaml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    steps = epochs * max(n_utts // batch_size, 1)
    interval = min(500, steps)  # at least one evaluate and checkpoint
    cfg["train"].update(
        batch_size=batch_size, epochs=epochs, log_interval=min(50, steps),
        eval_interval=interval, save_interval=interval,
    )
    cfg["data"].update(
        data_path=workdir,
        training_files=os.path.join(workdir, "train.csv"),
        validation_files=os.path.join(workdir, "val.csv"),
        speakers=["S0", "S1"], bucket_boundaries=[32, 160], max_text_len=40,
    )
    cfg["model"].update(upsample_initial_channel=256, n_layers=4)
    if tiny:
        cfg["model"].update(TINY_MODEL)
        cfg["train"].update(segment_size=2048, bf16_run=False)
    path = os.path.join(workdir, "config.yaml")
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    return path


def dominant_f0(wav: np.ndarray, sr: int) -> float:
    f = np.fft.rfftfreq(len(wav), 1 / sr)
    mag = np.abs(np.fft.rfft(wav * np.hanning(len(wav))))
    lo = np.searchsorted(f, 60)
    hi = np.searchsorted(f, 500)
    return float(f[lo + np.argmax(mag[lo:hi])])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--utts", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--tiny", action="store_true",
                        help="test-sized model and probe discriminator (a smoke run)")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    batch_size = min(args.batch_size, args.utts)

    make_dataset(args.workdir, args.utts)
    cfg_path = make_config(args.workdir, args.epochs, args.utts, batch_size, args.tiny)

    from vits_torch.config import get_hparams
    from vits_torch.serve.engine import TTSEngine
    from vits_torch.training.checkpoint import latest_checkpoint
    from vits_torch.training.train import run

    model_dir = os.path.join(args.workdir, "run")
    report = run(get_hparams(cfg_path, model_dir), device=args.device)
    print(f"trained steps {report.start_step + 1}-{report.state.step}: "
          f"loss/g/total {report.last_metrics['loss/g/total']:.3f}, "
          f"loss/d/total {report.last_metrics['loss/d/total']:.3f}")

    ckpt = latest_checkpoint(model_dir, "eval")
    engine = TTSEngine(os.path.join(model_dir, "config.yaml"), ckpt, device=args.device)
    f0 = {}
    for spk, target in [(0, 120), (1, 200)]:
        phones, (sr, audio) = engine.synthesize("[P]ni3#hao3[P]", spk)
        out = os.path.join(args.workdir, f"spk{spk}.wav")
        scipy.io.wavfile.write(out, sr, audio)
        f0[spk] = dominant_f0(audio.astype(np.float64), sr)
        print(f"speaker {spk}: f0={f0[spk]:.0f} Hz (target ~{target}) -> {out}")
    print(f"pitch identity (speaker 1 above speaker 0): {f0[1] > f0[0]}")
    for shift in (-6, 6):
        _, (sr, audio) = engine.synthesize("[P]ni3#hao3[P]", 0, scope_shift=shift)
        f0[f"shift{shift:+d}"] = dominant_f0(audio.astype(np.float64), sr)
        print(f"scope_shift {shift:+d}: f0={f0[f'shift{shift:+d}']:.0f} Hz")
    return f0


if __name__ == "__main__":
    main()
