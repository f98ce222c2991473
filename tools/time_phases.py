#!/usr/bin/env python3
"""Run one timed phase of a checkout's ``chip_smoke.py`` alone, so that two
trees can be timed in turns within one call on the card (parent, change,
change, parent).

    python3 tools/time_phases.py ROOT train-step [--bf16-only]   # phase 5
    python3 tools/time_phases.py ROOT train-run                  # phase 8
    python3 tools/time_phases.py ROOT train-step --variant pe:fused+dec:fused+disc:fused

``ROOT`` is the checkout whose ``chip_smoke.py`` and ``vits_torch`` are
imported: this repo (``.``), or an older tree unpacked with ``git archive``
into a directory that ``.gitignore`` lists. Every line the phase prints
carries the card's name and power limit; ``train-step`` ends with one
``PHASE5`` summary line a precision, ``train-run`` with one ``PHASE8``
line. ``--variant`` builds the bf16 policy's generator and discriminator
under a rounding variant of ``tools/bf16_bisect.py`` (this checkout's).
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("phase", choices=["train-step", "train-run"])
    ap.add_argument("--bf16-only", action="store_true", help="train-step: skip f32")
    ap.add_argument("--variant", default="", help="a tools/bf16_bisect.py variant")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from vits_torch import _build
    from vits_torch.config import load_hparams

    card = cs.card_line()
    label = f"{root.name}{' ' + args.variant if args.variant else ''}"
    if args.variant:
        spec = importlib.util.spec_from_file_location(
            "bf16_bisect", Path(__file__).resolve().parent / "bf16_bisect.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        tool.install(args.variant)
    print(f"{card} | root {root}, variant {args.variant or 'none (the package)'}", flush=True)
    _build.build(["mas"])
    config = root / "configs" / "config_cje.yaml"
    if args.phase == "train-run":
        (root / "_chip_scratch").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=root / "_chip_scratch") as tmp:
            out = cs.check_train_run(card, str(config), 0, Path(tmp))
        for tag in ("train", "resume"):
            r = out[tag]
            steps = sorted(r["step_s"])
            print(f"{card} | PHASE8 {label} {tag}: median interval "
                  f"{steps[len(steps) // 2] * 1e3:.2f} ms of {len(steps)}, peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        return 0
    hps = load_hparams(str(config))
    batch = cs.synthetic_batch(hps, np.random.default_rng(0), torch.device("cuda"))
    for bf16 in (True,) if args.bf16_only else (True, False):
        r = cs.check_train(card, hps, batch, 0, bf16)
        print(f"{card} | PHASE5 {label} {'bf16' if bf16 else 'f32'} median {r['ms'][0]:.2f} "
              f"min {r['ms'][1]:.2f} max {r['ms'][2]:.2f} ms, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
