#!/usr/bin/env python3
"""Per-file wall of a pytest run from its JUnit XML (``--junitxml``).

    python3 tools/test_walls.py RUN.xml [--top N]

Each test case's time is its setup, call and teardown, so a module-scoped
fixture counts with the first test that uses it and a file's sum is the time
its xdist worker spent on it: under ``--dist loadfile`` the largest sum is
the least wall the whole run can take. Prints the files by time, then the
sum over all files and the run's own wall as the XML states it.
"""

from __future__ import annotations

import argparse
import sys
import xml.etree.ElementTree as ET
from collections import defaultdict


def file_walls(path: str) -> tuple[dict, dict, float]:
    """({file: seconds}, {file: passed tests}, the run's wall in seconds)."""
    root = ET.parse(path).getroot()
    suites = [root] if root.tag == "testsuite" else root.findall("testsuite")
    walls, passed = defaultdict(float), defaultdict(int)
    for case in root.iter("testcase"):
        name = case.get("classname", "").split(".")
        # classname is tests.test_x[.Class]: the file is the first two parts
        f = "/".join(name[:2]) + ".py" if len(name) >= 2 else case.get("classname", "?")
        walls[f] += float(case.get("time", 0.0))
        if not any(c.tag in ("failure", "error", "skipped") for c in case):
            passed[f] += 1
    return dict(walls), dict(passed), sum(float(s.get("time", 0.0)) for s in suites)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml")
    ap.add_argument("--top", type=int, default=0, help="only the N longest files")
    args = ap.parse_args(argv)
    walls, passed, run_wall = file_walls(args.xml)
    rows = sorted(walls.items(), key=lambda kv: -kv[1])
    for f, s in rows[: args.top or None]:
        print(f"{s:9.2f} s  {passed.get(f, 0):4d} passed  {f}")
    print(f"{sum(walls.values()):9.2f} s  {sum(passed.values()):4d} passed  all files "
          f"(run wall {run_wall:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
