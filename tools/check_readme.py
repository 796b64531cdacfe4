"""Mechanical README <-> measurement-artifact consistency check.

Every performance figure in README.md must carry an inline annotation
binding it to a committed measurement artifact:

    **24.83 ESS/s** <!--chk:results/bench.json#value-->

The annotation names a JSON file (repo-relative) and a dotted path into
it; the checker extracts the LAST number before the marker on the same
line and requires agreement within 1% (or exact for integers).  A README
figure without a marker is fine — only annotated figures are enforced —
but tests/test_readme.py fails the suite when any annotated figure
drifts from its artifact, making the rounds-2..4 defect ("README numbers
contradict the measurements") structurally impossible for the numbers
that matter.

Usage: python tools/check_readme.py   (exit 0 = consistent)
"""

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MARK = re.compile(r"<!--chk:([\w./-]+)#([\w.\[\]]+)-->")
NUM = re.compile(r"(-?\d+(?:,\d{3})*(?:\.\d+)?)(?:x|%)?\**\s*"
                 r"(?:ESS/s|ms/iter|s/iter|iterations|rings|px)?\s*$")


def lookup(obj, path):
    for part in path.split("."):
        m = re.match(r"(\w+)\[(\d+)\]$", part)
        if m:
            obj = obj[m.group(1)][int(m.group(2))]
        else:
            obj = obj[part]
    return obj


def check(readme_path=None):
    readme_path = readme_path or os.path.join(ROOT, "README.md")
    failures = []
    nchecked = 0
    cache = {}
    with open(readme_path) as f:
        lines = f.readlines()
    for ln, line in enumerate(lines, 1):
        for m in MARK.finditer(line):
            fname, path = m.group(1), m.group(2)
            prefix = line[: m.start()]
            nums = re.findall(r"-?\d+(?:\.\d+)?", prefix.replace(",", ""))
            if not nums and ln >= 2:
                # markdown wrap: the figure may end the PREVIOUS line with
                # the marker alone leading this one
                nums = re.findall(r"-?\d+(?:\.\d+)?",
                                  lines[ln - 2].replace(",", ""))
            if not nums:
                failures.append(f"L{ln}: marker {fname}#{path} has no "
                                f"number before it")
                continue
            claimed = float(nums[-1])
            fpath = os.path.join(ROOT, fname)
            if fname not in cache:
                try:
                    with open(fpath) as jf:
                        cache[fname] = json.load(jf)
                except OSError as e:
                    failures.append(f"L{ln}: cannot read {fname}: {e}")
                    cache[fname] = None
                    continue
            if cache[fname] is None:
                continue
            try:
                actual = float(lookup(cache[fname], path))
            except (KeyError, IndexError, TypeError, ValueError) as e:
                failures.append(f"L{ln}: {fname}#{path}: {e!r}")
                continue
            tol = max(abs(actual) * 0.01, 0.05)
            if abs(claimed - actual) > tol:
                failures.append(
                    f"L{ln}: README says {claimed} but {fname}#{path} "
                    f"= {actual}")
            nchecked += 1
    return nchecked, failures


def main():
    nchecked, failures = check()
    for f in failures:
        print("README drift:", f)
    print(f"checked {nchecked} annotated figures, "
          f"{len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
