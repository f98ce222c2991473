#!/usr/bin/env python3
"""Run one timed phase of a checkout's ``chip_smoke.py`` alone, so that two
trees can be timed in turns within one call on the card (parent, change,
change, parent).

    python3 tools/time_phases.py ROOT train-step [--bf16-only]   # phase 5
    python3 tools/time_phases.py ROOT train-run                  # phase 8

``ROOT`` is the checkout whose ``chip_smoke.py`` and ``vits_torch`` are
imported: this repo (``.``), or an older tree unpacked with ``git archive``
into a directory that ``.gitignore`` lists. Every line the phase prints
carries the card's name and power limit; ``train-step`` ends with one
``PHASE5`` summary line a precision.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("phase", choices=["train-step", "train-run"])
    ap.add_argument("--bf16-only", action="store_true", help="train-step: skip f32")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from vits_torch import _build
    from vits_torch.config import load_hparams

    card = cs.card_line()
    print(f"{card} | root {root}", flush=True)
    _build.build(["mas"])
    config = root / "configs" / "config_cje.yaml"
    if args.phase == "train-run":
        with tempfile.TemporaryDirectory() as tmp:
            cs.check_train_run(card, str(config), 0, Path(tmp))
        return 0
    hps = load_hparams(str(config))
    batch = cs.synthetic_batch(hps, np.random.default_rng(0), torch.device("cuda"))
    for bf16 in (True,) if args.bf16_only else (True, False):
        r = cs.check_train(card, hps, batch, 0, bf16)
        print(f"{card} | PHASE5 {root.name} {'bf16' if bf16 else 'f32'} median {r['ms'][0]:.2f} "
              f"min {r['ms'][1]:.2f} max {r['ms'][2]:.2f} ms, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
