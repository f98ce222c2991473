"""Convergence study on the port (counterpart of ``tools/convergence_v2.py``):
does the port's alignment machinery LEARN, beyond matching the JAX package's
numbers step for step?

The corpus, the configuration and the four curves are the JAX tool's:

* 10 symbols, each with a distinct harmonic signature (f0 log-spaced
  120-490 Hz) AND a distinct characteristic duration (4-13 frames,
  decorrelated from pitch order), +-25% per-instance jitter;
* every utterance a different random sequence of 8-14 symbols, no
  immediate repeats; exact per-instance durations in ``gt.json``.
``gen`` writes the JAX tool's corpus byte for byte from the same seed (its
``_segment``, ``_decode_symbols`` and ``_levenshtein`` are copied here, not
imported: the port imports nothing of the JAX package).

Subcommands (run from the repo root; ``--device cpu`` off the card):
  gen     --workdir W             corpus + gt.json
  train   --workdir W --epochs N  the port's training CLI (vits_torch.training.train.run)
  analyze --workdir W             per-checkpoint metrics -> analysis.json (+ plot)
  synth   --workdir W             held-out-text synthesis order/duration check
  plot    --runs R.json --out P   curves of several runs ({label: analysis rows};
                                  --only label prefixes)

``analyze`` measures per eval checkpoint, with the port's model: (a) the
duration loss on a fixed val batch; (b) MAS against the known alignment,
frame accuracy and symbol-boundary MAE; (c) Pearson r of SDP-predicted
durations (reverse at ``noise_scale_w=0``) against the true ones; (d) the
same r for the MAS-extracted durations. ``synth`` decodes the audio of
``infer`` on 8 held-out texts back to symbols by dominant f0.

The study: ``gen``, ``train --epochs 250`` (4250 steps, ~35 min on an H100
at 700 W), ``analyze``, ``synth``, one after the other on the same workdir;
``analysis.json``, ``synth_check.json`` and ``run/train.log`` hold the
results. ``plot(rows, out, reference)`` draws the curves beside another
run's (``docs/convergence_r5_analysis.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SR = 22050
HOP = 256

# symbol -> (f0 Hz, mean duration in frames); durations shuffled so duration
# is not a monotonic function of pitch (Pearson r(f0, dur) = -0.03)
SYMS = list("aeiouksmnl")
F0S = {s: 120.0 * (490.0 / 120.0) ** (k / 9) for k, s in enumerate(SYMS)}
DURS = dict(zip(SYMS, [10, 5, 12, 7, 4, 9, 13, 6, 11, 8]))


def _segment(f0: float, n: int, spk: int, rng: np.random.Generator) -> np.ndarray:
    """One symbol's audio: harmonic stack with 8 ms cosine edges."""
    t = np.arange(n) / SR
    amps = (1.0, 0.5, 0.25) if spk == 0 else (1.0, 0.25, 0.45)
    sig = sum(a * np.sin(2 * np.pi * f0 * (h + 1) * t) for h, a in enumerate(amps))
    edge = int(0.008 * SR)
    env = np.ones(n)
    ramp = 0.5 * (1 - np.cos(np.pi * np.arange(edge) / edge))
    env[:edge] = ramp
    env[-edge:] = ramp[::-1]
    return 0.35 * sig * env + 0.004 * rng.standard_normal(n)


def gen(workdir: str, n_train: int = 256, n_val: int = 16, n_heldout: int = 8,
        seed: int = 0) -> None:
    import scipy.io.wavfile

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    gt: dict[str, dict] = {}
    rows: list[str] = []
    for i in range(n_train + n_val + n_heldout):
        spk = i % 2
        length = int(rng.integers(8, 15))
        seq: list[str] = []
        for _ in range(length):
            # adjacent symbols at least 2 f0 steps apart: crisp boundaries, so
            # the symbol decoder recovers ground-truth sequences exactly
            cands = [
                s for s in SYMS
                if not seq or abs(SYMS.index(s) - SYMS.index(seq[-1])) >= 2
            ]
            seq.append(cands[rng.integers(len(cands))])
        durs = [max(3, round(DURS[c] * rng.uniform(0.75, 1.25))) for c in seq]
        audio = np.concatenate(
            [_segment(F0S[c], d * HOP, spk, rng) for c, d in zip(seq, durs)]
        )
        path = os.path.join(workdir, f"utt{i:03d}.wav")
        scipy.io.wavfile.write(
            path, SR, (np.clip(audio, -1, 1) * 24000).astype(np.int16)
        )
        text = "".join(seq)
        lang = " ".join(["0"] * len(text))
        rows.append(f"{path}|S{spk}|{text}|{lang}")
        gt[os.path.basename(path)] = {"text": text, "durs": durs, "spk": spk}

    with open(os.path.join(workdir, "train.csv"), "w") as f:
        f.write("\n".join(rows[:n_train]) + "\n")
    with open(os.path.join(workdir, "val.csv"), "w") as f:
        f.write("\n".join(rows[n_train:n_train + n_val]) + "\n")
    with open(os.path.join(workdir, "heldout.csv"), "w") as f:
        f.write("\n".join(rows[n_train + n_val:]) + "\n")
    with open(os.path.join(workdir, "gt.json"), "w") as f:
        json.dump(gt, f)
    frames = [sum(v["durs"]) for v in gt.values()]
    print(f"wrote {len(rows)} utts to {workdir}; "
          f"frames min/med/max = {min(frames)}/{int(np.median(frames))}/{max(frames)}")


def make_config(workdir: str, epochs: int, model: dict | None = None,
                train: dict | None = None) -> str:
    """The JAX study's config: ``configs/config_cje.yaml`` with B=16,
    ``upsample_initial_channel`` 256, 4 text-encoder layers and its own bf16
    policy, every checkpoint kept; ``model`` and ``train`` override entries
    (a test's tiny widths)."""
    import yaml

    with open(os.path.join(ROOT, "configs", "config_cje.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["train"].update({
        "batch_size": 16, "epochs": epochs, "log_interval": 50,
        "eval_interval": 400, "save_interval": 400,  # steps
        "keep_ckpts": 0,  # keep every checkpoint for the per-step curves
        **(train or {}),
    })
    cfg["data"].update(
        data_path=workdir,
        training_files=os.path.join(workdir, "train.csv"),
        validation_files=os.path.join(workdir, "val.csv"),
        speakers=["S0", "S1"],
        bucket_boundaries=[32, 96, 128, 160, 200, 240],
        max_text_len=40,
    )
    cfg["model"].update({"upsample_initial_channel": 256, "n_layers": 4, **(model or {})})
    path = os.path.join(workdir, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def train(workdir: str, epochs: int, device=None, config: str | None = None):
    """Train with the port's ``run`` (on ``device``, the card by default)
    from ``config`` (default: ``make_config``'s)."""
    from vits_torch.config import get_hparams
    from vits_torch.training.train import run

    hps = get_hparams(config or make_config(workdir, epochs), os.path.join(workdir, "run"))
    return run(hps, device=device)


# -- analysis -------------------------------------------------------------------------


def _model(workdir: str, device):
    """hps and the generator of the study's config in f32 (as the JAX tool
    analyzes), in eval mode."""
    from vits_torch.config import get_hparams
    from vits_torch.models.synthesizer import build_synthesizer

    hps = get_hparams(os.path.join(workdir, "config.yaml"), os.path.join(workdir, "run"))
    return hps, build_synthesizer(hps, device=device, bf16=False).eval()


def _load_val_batch(hps, workdir: str):
    """Every val utterance, padded to common shapes, and its ground-truth
    per-symbol durations."""
    from vits_torch.ops.commons import intersperse_with_language_id
    from vits_torch.text import cleaned_text_to_sequence
    from vits_torch.training.train import build_dataset

    ds = build_dataset(hps, "val")
    with open(os.path.join(workdir, "gt.json")) as f:
        gt = json.load(f)
    xs, ts, specs, yings, sids, gt_durs = [], [], [], [], [], []
    for full, spk, text, _lang in ds.items:
        spec, ying, _audio = ds._get_audio(full)
        seq = cleaned_text_to_sequence(text)
        seq, lang_ids = intersperse_with_language_id(seq, [0] * len(seq), 0)
        xs.append(np.asarray(seq, np.int64))
        ts.append(np.asarray(lang_ids, np.int64))
        specs.append(spec)
        yings.append(ying)
        sids.append(0 if spk == "S0" else 1)
        gt_durs.append(gt[os.path.basename(full)]["durs"])

    bx = max(len(x) for x in xs)
    by = max(s.shape[0] for s in specs)
    n = len(xs)
    batch = {
        "x": np.zeros((n, bx), np.int64),
        "t": np.zeros((n, bx), np.int64),
        "x_lengths": np.asarray([len(x) for x in xs], np.int64),
        "spec": np.zeros((n, by, specs[0].shape[1]), np.float32),
        "spec_lengths": np.asarray([s.shape[0] for s in specs], np.int64),
        "ying": np.zeros((n, by, yings[0].shape[1]), np.float32),
        "sid": np.asarray(sids, np.int64),
    }
    for i in range(n):
        batch["x"][i, : len(xs[i])] = xs[i]
        batch["t"][i, : len(ts[i])] = ts[i]
        batch["spec"][i, : specs[i].shape[0]] = specs[i]
        batch["ying"][i, : yings[i].shape[0]] = yings[i]
    return batch, gt_durs


def _pearson(a, b):
    # an untrained SDP emits a constant: no correlation is defined
    if np.std(a) < 1e-9:
        return None
    return float(np.corrcoef(a, b)[0, 1])


def _ckpt_metrics(model, batch: dict, gt_durs: list) -> dict:
    """One checkpoint's alignment and duration metrics on the val batch."""
    import torch

    dev = model.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with torch.no_grad():
        out = model(b["x"], b["t"], b["x_lengths"], b["spec"], b["spec_lengths"], b["ying"],
                    b["sid"], generator=torch.Generator(dev).manual_seed(0))
        w_ceil = model.infer_pre_lr(b["x"], b["t"], b["x_lengths"], b["sid"],
                                    generator=torch.Generator(dev).manual_seed(0),
                                    noise_scale_w=0.0)[0]
    attn = out["attn"].float().cpu().numpy()  # [B, T_y, T_x] hard MAS path
    w_pred = w_ceil.float().cpu().numpy()[..., 0]

    correct = total = 0
    boundary_err: list[float] = []
    mas_durs, sdp_durs, true_durs = [], [], []
    for i, durs in enumerate(gt_durs):
        ty = int(batch["spec_lengths"][i])
        assert ty == sum(durs), (ty, sum(durs))
        # ground-truth frame -> symbol position p, whose token is 2p+1 (add_blank)
        gt_pos = np.repeat(np.arange(len(durs)), durs)
        correct += int(np.sum(attn[i, :ty].argmax(axis=-1) == 2 * gt_pos + 1))
        total += ty
        w_mas = attn[i, :ty].sum(axis=0)  # blanks' frames are MAS mass too
        cum_mas, cum_gt = np.cumsum(w_mas), np.cumsum(durs)
        # the boundary after symbol p is the end of token 2p+1
        boundary_err.extend(abs(cum_mas[2 * p + 1] - cum_gt[p]) for p in range(len(durs)))
        mas_durs.extend(w_mas[1::2][: len(durs)])
        sdp_durs.extend(w_pred[i, 1::2][: len(durs)])
        true_durs.extend(durs)
    true_durs = np.asarray(true_durs, np.float64)
    return {
        "dur_loss": float(out["l_length"].float().sum()),
        "mas_frame_acc": correct / total,
        "mas_boundary_mae": float(np.mean(boundary_err)),
        "r_mas": _pearson(np.asarray(mas_durs), true_durs),
        "r_sdp": _pearson(np.asarray(sdp_durs), true_durs),
    }


def analyze(workdir: str, device=None) -> list[dict]:
    from vits_torch.training.checkpoint import _ckpt_steps, load_eval_params

    hps, model = _model(workdir, device)
    batch, gt_durs = _load_val_batch(hps, workdir)
    model_dir = os.path.join(workdir, "run")
    steps = _ckpt_steps(model_dir, "eval")
    if not steps:
        raise SystemExit(f"no eval checkpoints in {model_dir}")
    rows = []
    for s in steps:
        model.load_state_dict(load_eval_params(os.path.join(model_dir, f"eval_{s}"),
                                               map_location=model.device))
        m = _ckpt_metrics(model, batch, gt_durs)
        m["step"] = s
        rows.append(m)
        print(json.dumps(m))
    out = os.path.join(workdir, "analysis.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("no plot: matplotlib does not import")
    else:
        plot(rows, os.path.join(workdir, "convergence_torch.png"))
    return rows


def plot(rows: list[dict], out: str, reference: list[dict] | None = None,
         others: dict[str, list[dict]] | None = None, label: str = "port") -> None:
    """The four curves of ``rows`` (and, dashed, of ``reference``; dotted,
    of each labelled run in ``others``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 4, figsize=(16, 3.2))
    panels = [
        ("dur_loss", "duration loss (fixed val batch)", None),
        ("mas_frame_acc", "MAS frame accuracy vs ground truth", (0, 1)),
        ("mas_boundary_mae", "MAS boundary MAE (frames)", None),
        ("r_sdp", "Pearson r: predicted vs true durations", (-0.2, 1)),
    ]

    def series(rs, key):
        pts = [(r["step"], r[key]) for r in rs if r[key] is not None]
        return [p[0] for p in pts], [p[1] for p in pts]

    runs = [(rows, "-", label), (reference, "--", "JAX")]
    runs += [(rs, ":", tag) for tag, rs in (others or {}).items()]
    for ax, (key, title, ylim) in zip(axes, panels):
        for rs, style, tag in runs:
            if not rs:
                continue
            ax.plot(*series(rs, key), style, marker="o", label=f"{tag}")
            if key == "r_sdp" and not others:
                ax.plot(*series(rs, "r_mas"), style, marker="s", label=f"{tag} MAS-extracted")
        ax.legend(fontsize=7)
        ax.set_title(title, fontsize=9)
        ax.set_xlabel("step")
        if ylim:
            ax.set_ylim(*ylim)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    print(f"wrote {out}")


# -- held-out synthesis check ------------------------------------------------------


def _decode_symbols(audio: np.ndarray) -> tuple[list[str], list[int]]:
    """Audio -> symbol sequence + per-run durations (frames).

    Per-frame dominant f0 (512-sample centered window, zero-padded FFT)
    scored against every symbol's f0 in log space, then Viterbi-smoothed
    with a switch penalty so boundary-bleed frames join a neighboring run
    instead of spawning spurious segments.
    """
    win, pad = 512, 8192
    n_frames = len(audio) // HOP
    w = np.hanning(win)
    fftf = np.fft.rfftfreq(pad, 1 / SR)
    lo, hi = np.searchsorted(fftf, 90), np.searchsorted(fftf, 560)
    f0_vals = np.asarray([F0S[s] for s in SYMS])
    half = win // 2
    f0s = np.empty(n_frames)
    for j in range(n_frames):
        c = j * HOP + HOP // 2
        seg = audio[max(0, c - half): c + half]
        if c - half < 0:
            seg = np.pad(seg, (half - c, 0))
        if len(seg) < win:
            seg = np.pad(seg, (0, win - len(seg)))
        mag = np.abs(np.fft.rfft(seg * w, n=pad))
        f0s[j] = fftf[lo + int(np.argmax(mag[lo:hi]))]

    cost = np.abs(np.log(f0s[:, None] / f0_vals[None, :]))  # [T, K]
    lam = 0.4  # symbol-switch penalty
    n, k = cost.shape
    dp = cost[0].copy()
    bp = np.zeros((n, k), int)
    same = np.eye(k, dtype=bool)
    for t_ in range(1, n):
        trans = dp[None, :] + lam * (~same)
        bp[t_] = trans.argmin(axis=1)
        dp = cost[t_] + trans.min(axis=1)
    path = [int(dp.argmin())]
    for t_ in range(n - 1, 0, -1):
        path.append(int(bp[t_, path[-1]]))
    path = path[::-1]

    seq: list[str] = []
    durs: list[int] = []
    for idx in path:
        if seq and seq[-1] == SYMS[idx]:
            durs[-1] += 1
        else:
            seq.append(SYMS[idx])
            durs.append(1)
    return seq, durs


def _levenshtein(a: list, b: list) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def synth(workdir: str, device=None) -> dict:
    import torch

    from vits_torch.ops.commons import intersperse_with_language_id
    from vits_torch.text import cleaned_text_to_sequence
    from vits_torch.training.checkpoint import latest_checkpoint, load_eval_params

    _, model = _model(workdir, device)
    ckpt = latest_checkpoint(os.path.join(workdir, "run"), "eval")
    model.load_state_dict(load_eval_params(ckpt, map_location=model.device))
    print(f"checkpoint: {ckpt}")
    dev = model.device

    results = []
    with open(os.path.join(workdir, "heldout.csv")) as f:
        lines = [line.strip() for line in f if line.strip()]
    for line in lines:
        _path, spk, text, _lang = line.split("|")
        seq, lids = intersperse_with_language_id(
            cleaned_text_to_sequence(text), [0] * len(text), 0
        )
        x = torch.tensor([seq], device=dev)
        t = torch.tensor([lids], device=dev)
        xl = torch.tensor([len(seq)], device=dev)
        sid = torch.tensor([0 if spk == "S0" else 1], device=dev)
        with torch.no_grad():
            wav, _, y_len = model.infer(x, t, xl, sid, generator=torch.Generator(dev).manual_seed(0),
                                        noise_scale=0.4, noise_scale_w=0.0, max_frames=320)
        audio = wav[0, : int(y_len[0]) * HOP, 0].double().cpu().numpy()
        dec_seq, dec_durs = _decode_symbols(audio)
        dist = _levenshtein(dec_seq, list(text))
        sim = 1 - dist / max(len(text), len(dec_seq))
        # realized durations against the per-symbol means, where the order is exact
        r = float("nan")
        if dec_seq == list(text):
            spec_d = np.asarray([DURS[c] for c in text], np.float64)
            r = float(np.corrcoef(np.asarray(dec_durs, np.float64), spec_d)[0, 1])
        results.append({"text": text, "decoded": "".join(dec_seq),
                        "exact": dec_seq == list(text), "sim": round(sim, 3),
                        "dur_r": None if np.isnan(r) else round(r, 3)})
        print(json.dumps(results[-1]))

    n_exact = sum(r["exact"] for r in results)
    rs = [r["dur_r"] for r in results if r["dur_r"] is not None]
    summary = {
        "n": len(results),
        "exact_order": n_exact,
        "mean_sim": round(float(np.mean([r["sim"] for r in results])), 3),
        "mean_dur_r": round(float(np.mean(rs)), 3) if rs else None,
    }
    print("SUMMARY", json.dumps(summary))
    with open(os.path.join(workdir, "synth_check.json"), "w") as f:
        json.dump({"results": results, "summary": summary}, f, indent=1)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="convergence study of the port")
    p.add_argument("cmd", choices=["gen", "train", "analyze", "synth", "plot"])
    p.add_argument("--workdir", default="conv_torch")
    p.add_argument("--runs", help="plot: JSON {label: analysis rows}; the first is solid, "
                                  "a label starting 'JAX' dashed")
    p.add_argument("--out", default="convergence_torch.png", help="plot: the image")
    p.add_argument("--only", default="", help="plot: comma-separated label prefixes to draw")
    p.add_argument("--epochs", type=int, default=250)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    if args.cmd == "gen":
        gen(args.workdir)
    elif args.cmd == "train":
        train(args.workdir, args.epochs, device=args.device)
    elif args.cmd == "analyze":
        analyze(args.workdir, device=args.device)
    elif args.cmd == "plot":
        with open(args.runs) as f:
            runs = json.load(f)
        if args.only:
            keep = tuple(args.only.split(","))
            runs = {k: v for k, v in runs.items() if k.startswith(keep)}
        ref = next((runs.pop(k) for k in list(runs) if k.startswith("JAX")), None)
        first = next(iter(runs))
        plot(runs.pop(first), args.out, reference=ref, others=runs, label=first)
    else:
        synth(args.workdir, device=args.device)


if __name__ == "__main__":
    main()
