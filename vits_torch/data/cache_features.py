"""Offline feature-cache pass: precompute .spec.npy / .ying.npy for filelists
(port of ``vits_tpu/data/cache_features.py``; the caches are the JAX
package's, byte for byte).

Behavioral reference: reference create_spec.py (spec cache pass run on
every training start) + the `--initial_run` ying warm-up
(TextAudioSpeakerLoader.py:55-59). CLI:
  python -m vits_torch.data.cache_features -c configs/config_cje.yaml
"""

from __future__ import annotations

import argparse

from vits_torch.config import load_hparams


def main(argv=None):
    parser = argparse.ArgumentParser(description="precompute .spec.npy / .ying.npy")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--filelists", nargs="*", default=None,
                        help="override config train/val filelists")
    args = parser.parse_args(argv)
    hps = load_hparams(args.config)

    from vits_torch.training.train import build_dataset

    if args.filelists:
        for fl in args.filelists:
            hps.data.training_files = fl
            ds = build_dataset(hps, "train", pt_run=True)
            print(f"{fl}: cached {len(ds)} items")
    else:
        for split in ("train", "val"):
            ds = build_dataset(hps, split, pt_run=True)
            print(f"{split}: cached {len(ds)} items")


if __name__ == "__main__":
    main()
