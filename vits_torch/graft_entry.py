"""The port's graft entry points (counterpart of ``__graft_entry__.py``).

  entry()             -> (fn, example_args): the flagship CJE generator's
                         ``infer`` (text -> waveform) on the card, its
                         weights from ``torch.manual_seed(0)``.
  dryrun_multichip(n) -> ONE full GAN training step under DDP over ``n``
                         gloo processes on the cards (rank r on
                         ``cuda:{r % device_count}``) or, given
                         ``device="cpu"``, on the CPU; the tiny model and
                         the probe discriminator of the JAX dryrun, through
                         ``parallel.mesh`` and ``training.step`` as a
                         ``--distributed`` run takes them.
  dryrun_multichip_2d(n) -> the same step on an (n/2) x 2 (data, model) mesh:
                         the batch's first n/2 rows over the data ranks, the
                         HiFi-GAN decoder's channels split over the model
                         ranks (``mesh.tp_shard_generator``).

    python -m vits_torch.graft_entry [N] [--device cpu]      # dryrun_multichip(N), N=2
    python -m vits_torch.graft_entry 2d [N] [--device cpu]   # dryrun_multichip_2d(N), N=8
"""

from __future__ import annotations

import argparse
import hashlib
from pathlib import Path

import numpy as np
import torch

from vits_torch.config import HParams, load_hparams
from vits_torch.models.avocodo import probe_discriminator
from vits_torch.models.synthesizer import SynthesizerTrn, build_synthesizer, resolve_device
from vits_torch.parallel import mesh
from vits_torch.text.symbols import symbols as _SYMBOLS
from vits_torch.training.step import create_train_state, replicate_state, train_step

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config_cje.yaml"
_N_SYMBOLS = len(_SYMBOLS)  # 71


def entry(device=None):
    """``fn(model, x, t, x_lengths, sid, generator) -> wav`` [1, 256 * hop,
    1] and its example arguments: the CJE generator at full width on
    ``device`` (``cuda`` unless it names another), 64 random symbol ids,
    speaker 0, the JAX entry's noise scales and ``max_frames=256``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_synthesizer(load_hparams(str(CONFIG)), device=device).eval()
    b, tx = 1, 64
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, _N_SYMBOLS, (b, tx))).to(device)
    t = torch.from_numpy(rng.integers(0, 6, (b, tx))).to(device)
    x_lengths = torch.tensor([tx], device=device)
    sid = torch.tensor([0], device=device)

    def fn(model, x, t, x_lengths, sid, generator):
        with torch.no_grad():
            wav, _, _ = model.infer(x, t, x_lengths, sid, generator=generator,
                                    noise_scale=0.667, noise_scale_w=0.8, max_frames=256)
        return wav

    return fn, (model, x, t, x_lengths, sid, torch.Generator(device).manual_seed(2))


def tiny_hps(**train) -> HParams:
    """hps of the tiny configurations (the JAX dryrun's and
    ``tests/test_train_step.py``'s); ``train`` overrides entries of
    hps.train."""
    return HParams(
        train={**dict(learning_rate=2e-4, betas=[0.8, 0.99], eps=1e-9, lr_decay=0.999875,
                      segment_size=2048, c_mel=45, c_kl=1.0, c_yin=45.0), **train},
        data=dict(filter_length=1024, hop_length=256, win_length=1024, n_mel_channels=80,
                  mel_fmin=0.0, mel_fmax=None, sampling_rate=22050),
    )


def _dryrun_model_and_batch(n: int, bf16: bool = False):
    """The JAX dryrun's tiny flagship-shaped model (every structural piece,
    depths and widths turned down) and the probe discriminator, both on the
    CPU (under the bf16 policy if ``bf16``), and its global batch of ``n``
    rows (one a rank)."""
    hps = tiny_hps()
    torch.manual_seed(0)
    model = SynthesizerTrn(
        num_chars=_N_SYMBOLS, spec_channels=513, segment_size=2048, midi_start=-5,
        midi_end=75, octave_range=24, inter_channels=96, hidden_channels=64,
        filter_channels=96, n_heads=2, n_layers=1, kernel_size=3, p_dropout=0.1,
        resblock="1", resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]],
        upsample_rates=[8, 8, 2, 2], upsample_initial_channel=16,
        upsample_kernel_sizes=[16, 16, 4, 4], yin_channels=80, yin_start=15, yin_scope=50,
        yin_shift_range=15, n_speakers=3, gin_channels=16, posterior_layers=2,
        flow_n_flows=1, flow_wn_layers=1, dur_n_flows=1, yin_dec_layers=2, bf16=bf16,
        device="cpu",
    )
    disc = probe_discriminator(segment_size=2048, bf16=bf16, device="cpu")
    b, tx, ty, hop = n, 9, 16, 256
    rng = np.random.default_rng(0)
    batch = {
        "x": rng.integers(1, _N_SYMBOLS, (b, tx)),
        "t": rng.integers(0, 6, (b, tx)),
        "x_lengths": np.full(b, tx),
        "spec": np.abs(rng.standard_normal((b, ty, 513))).astype(np.float32),
        "spec_lengths": np.full(b, ty),
        "ying": rng.uniform(0, 1, (b, ty, 80)).astype(np.float32),
        "wav": (rng.standard_normal((b, ty * hop, 1)) * 0.1).astype(np.float32),
        "sid": rng.integers(0, 3, (b,)),
    }
    return hps, model, disc, batch


def _dryrun_rank(n: int, device_type: str) -> dict:
    """One rank of ``dryrun_multichip``: its row of the global batch, one
    DDP step on its device (the card ``mesh.spawn`` set for it, or the
    CPU); the global metrics."""
    torch.set_num_threads(1)
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    hps, model, disc, batch = _dryrun_model_and_batch(n)
    state = replicate_state(
        create_train_state(model.to(dev), disc.to(dev), hps, steps_per_epoch=100), hps)
    rows = mesh.rank_rows(batch, mesh.process_index(), n, n)
    metrics = train_step(state, rows, hps, generator=torch.Generator(dev).manual_seed(1))
    return {k: float(v) for k, v in metrics.items()}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One data-parallel training step over ``n_devices`` gloo processes on
    ``device`` (the cards unless it names another: rank r on ``cuda:{r %
    device_count}``; ``"cpu"`` for the CPU); prints the JAX dryrun's ``ok``
    line and returns rank 0's (global) metrics."""
    device = resolve_device(device)
    metrics = mesh.spawn(_dryrun_rank, n_devices, n_devices, device.type, device=device,
                         backend="gloo")
    total = metrics[0]["loss/g/total"]
    if not all(np.isfinite(v) for m in metrics for v in m.values()) or any(
            m != metrics[0] for m in metrics):
        raise AssertionError(f"dryrun_multichip({n_devices}): ranks disagree or a loss is "
                             f"not finite: {metrics}")
    print(f"dryrun_multichip({n_devices}): ok, "
          f"loss/g/total={total:.3f} loss/d/total={metrics[0]['loss/d/total']:.3f}")
    return metrics[0]


def _replicated_digest(model: torch.nn.Module) -> str:
    """A digest of the bytes of every parameter a rank holds whole."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        if getattr(p, "tp_dim", None) is None:
            h.update(name.encode())
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dryrun_2d_rank(n: int, device_type: str) -> dict:
    """One rank of ``dryrun_multichip_2d``: the mesh, its data row's row of
    the batch, the decoder split over its model row, one step; the global
    metrics and a digest of its replicated parameters."""
    torch.set_num_threads(1)
    if device_type == "cuda":  # model peers must compute their replicas bit for bit alike
        torch.backends.cudnn.deterministic = True
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    m = mesh.make_mesh_2d(n // 2, 2)
    hps, model, disc, batch = _dryrun_model_and_batch(n)
    batch = {k: v[: m.n_data] for k, v in batch.items()}
    mesh.tp_shard_generator(model.to(dev), m)
    state = replicate_state(
        create_train_state(model, disc.to(dev), hps, steps_per_epoch=100), hps)
    rows = mesh.rank_rows(batch, m.data_index, m.n_data, m.n_data)
    metrics = train_step(state, rows, hps, generator=torch.Generator(dev).manual_seed(1))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "replicated": _replicated_digest(model), "model_index": m.model_index}


def dryrun_multichip_2d(n_devices: int, device=None) -> dict:
    """One training step on an ``n_devices / 2`` x 2 (data, model) mesh of
    gloo processes on ``device`` (as ``dryrun_multichip``): the batch's first
    ``n_devices / 2`` rows over the data ranks, the decoder's channels over
    the model ranks. Prints the JAX dryrun's ``ok`` line and returns rank
    0's (global) metrics; raises if the ranks' metrics differ or model
    peers' replicated parameters do."""
    if n_devices < 4 or n_devices % 2:
        raise ValueError("dryrun_multichip_2d needs an even n_devices >= 4")
    device = resolve_device(device)
    ranks = mesh.spawn(_dryrun_2d_rank, n_devices, n_devices, device.type, device=device,
                       backend="gloo")
    metrics = ranks[0]["metrics"]
    if not all(np.isfinite(v) for r in ranks for v in r["metrics"].values()) or any(
            r["metrics"] != metrics for r in ranks):
        raise AssertionError(f"dryrun_multichip_2d({n_devices}): ranks disagree or a loss is "
                             f"not finite: {[r['metrics'] for r in ranks]}")
    for d in range(0, n_devices, 2):
        if ranks[d]["replicated"] != ranks[d + 1]["replicated"]:
            raise AssertionError(f"dryrun_multichip_2d({n_devices}): ranks {d} and {d + 1} "
                                 "hold different replicated parameters after the step")
    print(f"dryrun_multichip_2d({n_devices}): ok, "
          f"loss/g/total={metrics['loss/g/total']:.3f} loss/d/total={metrics['loss/d/total']:.3f}")
    return metrics


def main(argv=None) -> dict:
    """``python -m vits_torch.graft_entry [N] [--device cpu]`` or
    ``python -m vits_torch.graft_entry 2d [N] [--device cpu]``."""
    ap = argparse.ArgumentParser(description="one train step over N processes: data parallel, "
                                 "or with '2d' on an N/2 x 2 (data, model) mesh")
    ap.add_argument("args", nargs="*", metavar="[2d] [N]")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    if args.args[:1] == ["2d"]:
        n = int(args.args[1]) if len(args.args) > 1 else 8
        return dryrun_multichip_2d(n, device=args.device)
    n = int(args.args[0]) if args.args else 2
    return dryrun_multichip(n, device=args.device)


if __name__ == "__main__":
    main()
