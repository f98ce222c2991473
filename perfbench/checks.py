"""How ``correct`` is decided: the program's outputs against the plain
reference (``perfbench/reference``), run once the window has closed and the
program's state is freed. The limits are the cell's
(``perfbench/checks/<cell>.json``); ``PERF.md`` gives the readings each was set
from.

Training (the first ``check_steps`` steps of set-up, one at each bucket of
``traffic.check_buckets``, the largest among them; they go through the
window's own call and feed). The reference is handed the same weights,
batches and draws and follows the same steps in float32 with TF32 off, a
block of rows at a time. Compared:

- ``g_loss_gap``, ``d_loss_gap``: the largest relative gap of a step's total
  generator (discriminator) loss over the checked steps, |program -
  reference| / |reference|;
- ``grad_gap``: the first update's gradient, leaf by leaf (the program's
  from AdamW's state after it): each leaf's gap between the program's norm
  and the reference's, over the larger of the reference's norm of that leaf
  and the median leaf's norm; the median of those gaps over the leaves;
- ``grad_gap.<module>``: the same over the moved leaves (below) of one of
  the generator's modules, for each one the limits file names: a module
  that the batch's rows set and the bf16 groups' rounding hardly touches
  (the pitch decoder, ``yin_decoder``: float32, its gradient from one L1
  loss, whose signs a rounded input seldom flips), where a half batch
  shows at once;
- ``delta_gap``, ``delta_gap.g_bf16``, ``delta_gap.d``: the change of each
  leaf over the checked steps, the same measure and its median, over the
  generator's leaves the configuration computes in float32, the generator's
  leaves of its bf16 groups (the posterior and pitch encoders, the
  waveform decoder), and the discriminator's leaves. Every leaf is in one of
  them, save those whose reference gradient is under a thousandth of the
  median leaf's: they move by round-off alone under Adam (an attention
  key's bias under softmax; the layers that the flows' zero-initialised
  outputs hold still at the first step). A group left unchanged reads 1;
- ``mas_path_off``: the cells in which the path ``maximum_path`` returned
  in the checked steps differs from the reference's dynamic program run on
  the same inputs (exact). The program's own scores are its state: the
  reference's own scores differ by the bf16 groups' rounding, which can
  flip a near tie, and reach the losses above;
- ``dropout_sites``: dropout modules of the program that the reference does
  not have, or the other way round (exact).

A cell compares the numbers its limits file names, and the two exact ones.
The largest leaf gaps swing from seed to seed with the bfloat16 rounding of
a few small decoder leaves (``PERF.md`` gives the look), so medians are
compared; the run's log names the worst leaves.
"""

from __future__ import annotations

import contextlib
import re
import statistics
import sys

import numpy as np
import torch

from perfbench import randomness, weights
from perfbench.harness import Check
from perfbench.reference import precision


# a request's audio error in the yardstick's units is taken over at least
# this error (float32 rounding of a request's audio), so that it is finite
# where the yardstick's flags change nothing (the CPU)
ERR_FLOOR = 1e-6

# the generator's leaves of the modules the bf16 policy computes in bfloat16
BF16_GROUPS = re.compile(r"^g\.(waveform_decoder|posterior_encoder|pitch_encoder)\.")
# each group of leaves and the number that compares its change
DELTA_NUMBERS = {"g": "delta_gap", "g_bf16": "delta_gap.g_bf16", "d": "delta_gap.d"}


def leaf_group(key: str) -> str:
    if key.startswith("d."):
        return "d"
    return "g_bf16" if BF16_GROUPS.match(key) else "g"


def build_reference(hps, device, bf16: bool = False):
    """The reference generator and discriminator, built on ``device``."""
    from perfbench.reference.models.avocodo import AvocodoDiscriminator, probe_discriminator
    from perfbench.reference.models.synthesizer import build_synthesizer

    with torch.device(device):
        g = build_synthesizer(hps, device=device, bf16=bf16)
        make = probe_discriminator if str(hps.model.get("discriminator_size", "flagship")) \
            == "probe" else AvocodoDiscriminator
        d = make(bf16=bf16, segment_size=hps.train.segment_size, device=device)
    return g, d


def both_shapes(g, d) -> dict:
    return {**{f"g.{k}": v for k, v in weights.shapes_of(g).items()},
            **{f"d.{k}": v for k, v in weights.shapes_of(d).items()}}


def load_both(g, d, w: dict) -> None:
    weights.load(g, {k[2:]: v for k, v in w.items() if k.startswith("g.")})
    weights.load(d, {k[2:]: v for k, v in w.items() if k.startswith("d.")})


@torch.no_grad()
def param_deltas(g, d, seed: int, device) -> dict[str, float]:
    """Each leaf's norm of (now - the seeded start)."""
    start = weights.make(both_shapes(g, d), seed, device)
    now = {**{f"g.{k}": p for k, p in g.named_parameters()},
           **{f"d.{k}": p for k, p in d.named_parameters()}}
    return {k: float((now[k] - start[k]).norm()) for k in now}


def _frozen_step(opt) -> None:
    """The fault of ``perfbench/control.py``: ``opt``'s update computed (its
    first gradient read) and then undone, so its parameters stay as they
    were."""
    real = opt.step

    def step():
        before = [p.detach().clone() for _, p in opt.params]
        real()
        with torch.no_grad():
            for (_, p), b in zip(opt.params, before):
                p.copy_(b)

    opt.step = step


def reference_steps(run, hps, feed, noise_fn, buckets: list[int], *, bf16=False, fp8=False,
                    rows=None, freeze_d=False) -> dict:
    """The reference's losses, first gradients and changes over the checked
    steps, one at each of ``buckets``; ``bf16``/``fp8``/``rows``/``freeze_d``
    make the controls and faults of ``perfbench/control.py``."""
    from perfbench.reference import step as ref_step

    dev = run.device
    tr = run.traffic
    numerics = precision.fp8() if fp8 else contextlib.nullcontext()
    with precision.exact(), numerics:
        g, d = build_reference(hps, dev, bf16=bf16)
        load_both(g, d, weights.make(both_shapes(g, d), run.seed, dev))
        drops = randomness.install_dropout(g, dev)
        opt_g, opt_d = ref_step.make_adamw(hps, g), ref_step.make_adamw(hps, d)
        if freeze_d:
            _frozen_step(opt_d)
        losses = []
        for k, bucket in enumerate(buckets):
            tag = ("check", k)
            batch = feed.batch(bucket, tag)
            noise = noise_fn(bucket, tag)

            def before(i, j, full, tag=tag):
                randomness.reseed_dropout(drops, run.seed, tag)
                for m in drops.values():
                    m.rows = (i, j, full)

            out = ref_step.train_step_blocks(g, d, opt_g, opt_d, batch, hps, noise,
                                             int(tr.ref_block), before, rows=rows)
            losses.append((out["g"], out["d"]))
        grads = {**{"g." + n: v for n, v in opt_g.first_grads.items()},
                 **{"d." + n: v for n, v in opt_d.first_grads.items()}}
        deltas = param_deltas(g, d, run.seed, dev)
    del g, d, opt_g, opt_d
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grads": grads, "deltas": deltas, "drops": sorted(drops)}


def _leaf_gaps(prog: dict, ref: dict, keys) -> list[tuple[float, str]]:
    """(gap, leaf) of every leaf named, largest first."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return sorted(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k) for k in keys),
                  reverse=True)


def _median_gap(prog: dict, ref: dict, keys) -> float:
    return statistics.median(g for g, _ in _leaf_gaps(prog, ref, keys))


def moved_leaves(ref: dict) -> list[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref["grads"].values())
    return [k for k, v in ref["grads"].items() if v >= 1e-3 * med]


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> str:
    """The leaves that set grad_gap and delta_gap, for the run's log."""
    med = statistics.median(ref["grads"].values())
    moved = moved_leaves(ref)
    parts = []
    for name, key, keys in (("grad", "grads", ref["grads"]), ("delta", "deltas", moved)):
        top = _leaf_gaps(prog[key], ref[key], keys)[:n]
        parts.append(f"{name}: " + ", ".join(
            f"{k} {g:.4g} ({prog[key][k]:.4g} vs {ref[key][k]:.4g})" for g, k in top))
    return "; ".join(parts)


def modules_named(limits: dict) -> list[str]:
    """The generator's modules of the ``grad_gap.<module>`` numbers of a
    limits file."""
    return [k.split(".", 1)[1] for k in limits if k.startswith("grad_gap.")]


def train_numbers(prog: dict, ref: dict, modules=()) -> dict:
    """The compared numbers of the module docstring, ``grad_gap.<m>`` for
    each of ``modules``."""
    def loss_gap(side: int) -> float:
        return max(abs(p[side] - r[side]) / max(abs(r[side]), 1e-30)
                   for p, r in zip(prog["losses"], ref["losses"]))

    out = {"g_loss_gap": loss_gap(0), "d_loss_gap": loss_gap(1)}
    if set(prog["grads"]) != set(ref["grads"]):
        nan = float("nan")
        return {**out, "grad_gap": nan, **{f"grad_gap.{m}": nan for m in modules},
                **{n: nan for n in DELTA_NUMBERS.values()}}
    out["grad_gap"] = _median_gap(prog["grads"], ref["grads"], ref["grads"])
    moved = moved_leaves(ref)
    for m in modules:
        keys = [k for k in moved if k.startswith(f"g.{m}.")]
        out[f"grad_gap.{m}"] = _median_gap(prog["grads"], ref["grads"], keys) if keys \
            else float("nan")
    for group, name in DELTA_NUMBERS.items():
        keys = [k for k in moved if leaf_group(k) == group]
        out[name] = _median_gap(prog["deltas"], ref["deltas"], keys)
    return out


def mas_path_off(calls) -> int:
    """Cells where the program's path differs from the reference's dynamic
    program on the same scores; ``calls``: (scores, mask, path) of each call
    of the program's ``maximum_path``, on the host."""
    from perfbench.reference.ops.mas import maximum_path

    return sum(int(((maximum_path(neg, mask) > 0) != path).sum()) for neg, mask, path in calls)


def train_reference(run, hps, feed, seen: dict, noise_fn, buckets: list[int]) -> list[Check]:
    try:
        ref = reference_steps(run, hps, feed, noise_fn, buckets)
    except ValueError as e:  # the program's parameters are not the reference's
        print(f"perfbench: {e}", file=sys.stderr)
        return [Check("parameters_match", 1.0, 0.0)]
    nums = train_numbers(seen, ref, modules_named(run.limits))
    run.raw = {"prog": {k: v for k, v in seen.items() if k != "mas"}, "ref": ref}
    if set(seen["grads"]) == set(ref["grads"]):
        print(f"perfbench: {nums}; losses {seen['losses']} vs {ref['losses']}; "
              + worst_leaves(seen, ref), file=sys.stderr)
    lim = run.limits
    sites = len(set(seen["drops"]) ^ set(ref["drops"]))
    return [Check(k, float(v), float(lim[k])) for k, v in nums.items() if k in lim] + [
        Check("mas_path_off", float(mas_path_off(seen["mas"])), 0.0),
        Check("dropout_sites", float(sites), 0.0)]


# -- serving ---------------------------------------------------------------
#
# A sample of the requests the window finished, drawn from the seed, with
# the longest in it, run by the reference one at a time (float32, TF32 off)
# with the same weights and draws. Compared:
#
# - ``ids_off``: requests whose ids from the program's frontend differ from
#   the frozen frontend's (exact);
# - ``frames_off``: the largest number of frames by which a request's
#   audio is longer or shorter than the reference's, beyond one frame for
#   each token whose duration lies within ``ambiguous_rel`` of a whole number
#   (such a token may round either way) (exact);
# - ``audio_ratio``: each request's relative error ||program - reference||
#   / ||reference|| over its samples compared, in units of the same error of
#   the reference computed with PyTorch's default flags (TF32 in cuDNN's
#   convolutions), which the engine leaves on; the largest over the sample.
#   A sound program reads about 1 on every request whatever the seed; the
#   error itself moves tenfold with the seeded weights (PERF.md). The samples compared are the
#   frames no such token can move, and never a piece's last
#   ``tail_margin`` frames (the decoder sees the padding of the engine's frame
#   bucket there). Pieces are found in the request's audio from its start up
#   to the first piece with such a token, and from its end back to the last
#   one; a piece with such a token is compared up to ``ambiguous_margin``
#   frames before its first such token.
# The share of the sample's audio compared is written to the run's log.


def ambiguous(w: np.ndarray, rel: float, frames: int) -> np.ndarray:
    """Indices of tokens whose ceil(w) could go either way, among those
    that start inside the piece's frames."""
    k = np.rint(w)
    starts = np.concatenate([[0], np.cumsum(np.ceil(w))[:-1]])
    return np.nonzero((k >= 1) & (np.abs(w - k) < rel * w) & (starts < frames))[0]


def _sums(ref: np.ndarray, got, n: int) -> tuple[float, float]:
    """(sum of squared differences, sum of squares of the reference) over
    the first n samples; NaN where the program's audio ends before them."""
    if len(got) < n:
        return float("nan"), 1.0
    d = np.asarray(got[:n], np.float64) - ref[:n]
    return float(d @ d), float(np.asarray(ref[:n], np.float64) @ ref[:n])


def compare_request(pieces: list[dict], audio, ids_prog, ids_ref, hop: int, lim: dict) -> dict:
    rel, margin, tail = lim["ambiguous_rel"], lim["ambiguous_margin"], lim["tail_margin"]
    ids_off = int(ids_prog is None or not np.array_equal(np.asarray(ids_prog), ids_ref))
    amb = [ambiguous(p["w"], rel, p["frames"]) for p in pieces]
    total = sum(p["frames"] for p in pieces)
    frames_off = max(0.0, abs(len(audio) / hop - total) - sum(len(a) for a in amb))
    moved = [i for i, a in enumerate(amb) if len(a)]
    first, last = (moved[0], moved[-1]) if moved else (len(pieces), len(pieces))
    diff, norm, compared = 0.0, 0.0, 0
    offset = 0
    for i in range(min(first + 1, len(pieces))):  # from the start
        p = pieces[i]
        upto = p["frames"] - tail
        if len(amb[i]):
            upto = min(upto, int(np.cumsum(np.ceil(p["w"]))[amb[i][0]] - np.ceil(
                p["w"][amb[i][0]])) - margin)
        n = max(0, upto) * hop
        dd, nn = _sums(p["audio"], audio[offset:], n)
        diff, norm, compared = diff + dd, norm + nn, compared + n
        offset += p["frames"] * hop
    end = len(audio)
    for i in range(len(pieces) - 1, last, -1):  # from the end, after the last moved piece
        p = pieces[i]
        start = end - p["frames"] * hop
        n = max(0, p["frames"] - tail) * hop
        dd, nn = _sums(p["audio"], audio[start:] if start >= 0 else [], n)
        diff, norm, compared = diff + dd, norm + nn, compared + n
        end = start
    return {"ids_off": ids_off, "frames_off": frames_off, "diff": diff, "norm": norm,
            "compared": compared, "samples": total * hop}


def serve_numbers(run, hps, records: list[dict], noise_fn) -> dict:
    """The compared numbers over ``records`` (text, speaker_id, seed, audio,
    ids: the program's)."""
    from perfbench.reference import serve as ref_serve
    from perfbench.reference.models.synthesizer import build_synthesizer

    dev = run.device
    lim = run.limits
    hop = hps.data.hop_length
    with precision.exact():
        with torch.device(dev):
            g = build_synthesizer(hps, device=dev)
        shapes = {f"g.{k}": v for k, v in weights.shapes_of(g).items()}
        weights.load(g, {k[2:]: v for k, v in weights.make(shapes, run.seed, dev).items()})
        g.eval()
        agg = {"ids_off": 0, "frames_off": 0.0, "compared": 0, "samples": 0}
        errors, ratios = [], []
        for r in records:
            seq, lang = ref_serve.phonemes(r["text"], bool(hps.data.add_blank))

            def synth():
                return [ref_serve.synth_piece(g, s, la, r["speaker_id"], noise_fn,
                                              (r["seed"] + i) & 0xFFFFFFFF,
                                              int(run.traffic.max_frames))
                        for i, (s, la) in enumerate(ref_serve.split_segments(seq, lang))]

            pieces = synth()
            with precision.defaults():
                yardstick = np.concatenate([p["audio"] for p in synth()])
            one = compare_request(pieces, r["audio"], r.get("ids"), seq, hop, lim)
            base = compare_request(pieces, yardstick, seq, seq, hop, lim)
            agg["frames_off"] = max(agg["frames_off"], one["frames_off"])
            for k in ("ids_off", "compared", "samples"):
                agg[k] += one[k]
            if one["norm"] > 0:
                err, unit = (one["diff"] / one["norm"]) ** 0.5, (base["diff"] / one["norm"]) ** 0.5
                errors.append(err)
                ratios.append(err / max(unit, ERR_FLOOR))
            elif one["diff"] != 0:
                ratios.append(float("nan"))
    del g
    print(f"perfbench: the audio compared is {agg['compared'] / max(agg['samples'], 1):.4f} of "
          f"the sample's ({len(records)} requests)", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ratio = max(ratios) if ratios and all(e == e for e in ratios) else float("nan")
    print(f"perfbench: each request's audio error {[float(f'{e:.4g}') for e in errors]}, "
          f"in the yardstick's units {[float(f'{e:.4g}') for e in ratios]}", file=sys.stderr)
    return {"ids_off": float(agg["ids_off"]), "frames_off": float(agg["frames_off"]),
            "audio_ratio": ratio}


def serve_checks(nums: dict, lim: dict) -> list[Check]:
    return [Check("ids_off", nums["ids_off"], 0.0), Check("frames_off", nums["frames_off"], 0.0),
            Check("audio_ratio", nums["audio_ratio"], float(lim["audio_ratio"]))]
