#!/usr/bin/env python3
"""Where a pytest run's time went, from its junit xml:

    python3 tools/test_times.py RUN.xml              # one JSON line a file
    python3 tools/test_times.py RUN.xml --tests 15   # then the 15 slowest tests
    python3 tools/test_times.py RUN.xml --match test_torch_
    python3 tools/test_times.py BEFORE.xml --against AFTER.xml

A line a file, slowest first: ``{"file", "seconds", "tests", "slowest",
"slowest_s", "setup_s"}``. A testcase's junit time is its setup, call and
teardown together, so a module fixture's cost sits in the first test that
asks for it; ``setup_s`` estimates it as the first test's time less the
median of the file's other tests (0 when that is negative). The last line
sums the files matched: ``{"total_s", "files", "tests", "passed", "failed",
"errors", "skipped"}``, and, with ``--match``, the same for the files that
do not match (``rest_s``). ``--against`` prints both runs' seconds a file
and the change, then both totals.
"""

import argparse
import json
import statistics
import xml.etree.ElementTree as ET


def cases(path):
    """[(file, test name, seconds, outcome)] in the order the xml lists
    them."""
    out = []
    for case in ET.parse(path).getroot().iter("testcase"):
        mod = case.get("classname", "")
        parts = mod.split(".")
        # classname is "tests.test_x" or "tests.test_x.TestClass"
        i = next((k for k, p in enumerate(parts) if p.startswith("test_")),
                 len(parts) - 1)
        name = case.get("name", "")
        if i + 1 < len(parts):
            name = ".".join(parts[i + 1:]) + "::" + name
        outcome = "passed"
        for tag in ("failure", "error", "skipped"):
            if case.find(tag) is not None:
                outcome = {"failure": "failed", "error": "errors"}.get(tag, tag)
        out.append(("/".join(parts[:i + 1]) + ".py", name,
                    float(case.get("time", 0) or 0), outcome))
    return out


def per_file(rows):
    files = {}
    for f, name, t, _ in rows:
        files.setdefault(f, []).append((name, t))
    out = []
    for f, tests in files.items():
        slow = max(tests, key=lambda x: x[1])
        rest = [t for _, t in tests[1:]]
        setup = tests[0][1] - statistics.median(rest) if rest else 0.0
        out.append({"file": f, "seconds": round(sum(t for _, t in tests), 3),
                    "tests": len(tests), "slowest": slow[0],
                    "slowest_s": round(slow[1], 3),
                    "setup_s": round(max(0.0, setup), 3)})
    return sorted(out, key=lambda r: -r["seconds"])


def totals(rows):
    out = {"total_s": round(sum(r[2] for r in rows), 3),
           "files": len({r[0] for r in rows}), "tests": len(rows)}
    for k in ("passed", "failed", "errors", "skipped"):
        out[k] = sum(r[3] == k for r in rows)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml")
    ap.add_argument("--match", default="",
                    help="only the files whose path holds this string")
    ap.add_argument("--tests", type=int, default=0,
                    help="also print the N slowest tests")
    ap.add_argument("--against", help="a second run's xml to compare with")
    a = ap.parse_args(argv)
    rows = cases(a.xml)
    mine = [r for r in rows if a.match in r[0]]
    if a.against:
        other = [r for r in cases(a.against) if a.match in r[0]]
        before = {r["file"]: r["seconds"] for r in per_file(mine)}
        after = {r["file"]: r["seconds"] for r in per_file(other)}
        for f in sorted(set(before) | set(after),
                        key=lambda f: -before.get(f, 0)):
            b, c = before.get(f, 0.0), after.get(f, 0.0)
            print(json.dumps({"file": f, "before_s": b, "after_s": c,
                              "change_s": round(c - b, 3)}))
        tb, ta = totals(mine), totals(other)
        print(json.dumps({"before": tb, "after": ta, "change": round(
            (ta["total_s"] - tb["total_s"]) / max(tb["total_s"], 1e-9), 4)}))
        return 0
    for r in per_file(mine):
        print(json.dumps(r))
    for f, name, t, outcome in sorted(mine, key=lambda r: -r[2])[:a.tests]:
        print(json.dumps({"test": f"{f}::{name}", "seconds": t,
                          "outcome": outcome}))
    tot = totals(mine)
    if a.match:
        tot["rest_s"] = totals([r for r in rows if a.match not in r[0]])["total_s"]
    print(json.dumps(tot))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
