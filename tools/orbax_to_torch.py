#!/usr/bin/env python3
"""Convert an ``eval_{step}`` checkpoint of the JAX package (an Orbax
directory written by ``vits_tpu.training.checkpoint.save_checkpoint``) into
the port's ``eval_{step}`` file, which ``vits_torch.serve.engine.TTSEngine``
and ``vits_torch.training.checkpoint.load_eval_params`` load:

    python tools/orbax_to_torch.py runs/jax/eval_40000 -c configs/config_cje.yaml \\
        --out-dir runs/torch

The generator is built from the config on the CPU and the flax tree is
loaded into it strictly (``vits_torch.utils.convert_jax.load_flax_params``):
a missing entry or a shape that differs raises. Needs JAX and orbax, so it
runs where the JAX package runs; it is not part of the port's import path.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vits_torch.config import load_hparams  # noqa: E402
from vits_torch.models.synthesizer import build_synthesizer  # noqa: E402
from vits_torch.utils.convert_jax import load_flax_params  # noqa: E402


def convert(src: str, config_path: str, out_dir: str) -> str:
    """JAX eval_{step} directory -> ``out_dir/eval_{step}``; returns its path."""
    from vits_tpu.training.checkpoint import load_eval_params

    g_params = load_eval_params(src)  # raw restore: the full generator tree
    model = build_synthesizer(load_hparams(config_path), device="cpu")
    load_flax_params(model, {"params": g_params})
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, os.path.basename(os.path.normpath(src)))
    torch.save({"g_params": model.state_dict()}, out)
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the JAX package's eval_{step} directory")
    ap.add_argument("-c", "--config", required=True, help="the config it was trained with")
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    out = convert(args.src, args.config, args.out_dir)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
