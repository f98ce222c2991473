"""Offline g2p preprocessing: run clean_text over filelists and write
`*.clr.csv` with the language-id column appended (port of
``vits_tpu/data/preprocess.py``, on the port's text frontend; the same
output byte for byte).

Behavioral reference: reference preprocess.py:9-34.
CLI: python -m vits_torch.data.preprocess --filelists a.csv b.csv
"""

from __future__ import annotations

import argparse

from vits_torch.text.cleaners import clean_text


def preprocess_filelist(path: str, out_path: str | None = None, text_index: int = 2):
    out_path = out_path or path.replace(".csv", ".clr.csv")
    new_lines = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("|")
            cleaned, lang = clean_text(parts[text_index])
            parts = parts[:text_index] + [cleaned, " ".join(map(str, lang))]
            new_lines.append("|".join(parts))
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(new_lines) + "\n")
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description="g2p over filelists -> *.clr.csv")
    parser.add_argument("--filelists", nargs="+", required=True)
    parser.add_argument("--text-index", type=int, default=2)
    args = parser.parse_args(argv)
    for path in args.filelists:
        out = preprocess_filelist(path, text_index=args.text_index)
        print(f"{path} -> {out}")


if __name__ == "__main__":
    main()
