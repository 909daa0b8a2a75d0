"""CLI for the port's invariant checker: ``python -m heat_tpu_torch.analysis``.

Exit status is the contract CI blocks on: 0 when every finding is either
fixed, pragma-suppressed (with a reason), or baselined — and the baseline has
no stale entries — else 1. ``--check`` is an explicit alias for the default
blocking mode (kept so the CI invocation reads as a gate); ``--write-baseline``
regenerates the grandfathered set; ``--dump-lockgraph`` exports the discovered
lock-acquisition graph (.json or .dot by extension) for
``doc/source/_static/``; ``--fix-unused-pragmas`` (dry-run; ``--write`` to
apply) mechanically removes pragmas the checker flags as suppressing nothing.

It scans ``heat_tpu_torch/`` (or ``--root``) and the repository's
``chip_smoke.py``, against ``analysis_baseline_torch.json`` at the root; the
committed lock graph is ``doc/source/_static/lock_graph_torch.json`` (and
``.dot``). Repeat runs are served from the incremental cache
``.analysis_cache_torch.json`` at the root (content-hash keyed, per-module
findings + dataflow summaries; all-or-nothing reuse because the SPMD/layout
rules are interprocedural — see ``analysis/cache.py``). ``--no-cache``
bypasses it, ``--cache PATH`` repoints it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import baseline as baseline_mod
from . import cache as cache_mod
from . import dataflow, pragmas, rules, rules_locks
from .engine import default_extra_files, run_analysis

REPORT_SCHEMA = "heat-tpu-analysis/1"
BASELINE_NAME = "analysis_baseline_torch.json"


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _rule_counts(findings) -> dict:
    counts: dict = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return dict(sorted(counts.items()))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.analysis",
        description="heat_tpu_torch invariant checker (static analysis)",
    )
    parser.add_argument("--baseline", default=None,
                        help=f"baseline JSON (default: <repo>/{BASELINE_NAME} "
                             "when present)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline from the current findings and exit 0")
    parser.add_argument("--check", action="store_true",
                        help="blocking mode (the default behaviour; kept explicit for CI)")
    parser.add_argument("--explain", metavar="RULE",
                        help="print one rule's invariant and origin, then exit")
    parser.add_argument("--json", metavar="PATH",
                        help="write the findings report as JSON to PATH")
    parser.add_argument("--dump-lockgraph", metavar="PATH",
                        help="write the lock-acquisition graph (.dot or .json) and exit")
    parser.add_argument("--root", default=None,
                        help="package root to scan (default: this heat_tpu_torch)")
    parser.add_argument("--no-cache", action="store_true",
                        help="bypass the incremental analysis cache")
    parser.add_argument("--cache", metavar="PATH", default=None,
                        help=f"cache file (default: <repo>/{cache_mod.CACHE_NAME})")
    parser.add_argument("--fix-unused-pragmas", action="store_true",
                        help="plan the mechanical removal of pragma-unused "
                             "suppressions (dry-run; nothing is modified)")
    parser.add_argument("--write", action="store_true",
                        help="with --fix-unused-pragmas: apply the removals")
    args = parser.parse_args(argv)

    if args.explain:
        print(rules.explain(args.explain))
        return 0 if args.explain in rules.RULES or args.explain in rules.NOT_PORTED else 1

    package_root = args.root
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = os.path.dirname(os.path.abspath(package_root))
    extra_files = default_extra_files(package_root)

    # ---- incremental cache: serve a byte-identical tree without re-running
    cache_path = args.cache or cache_mod.default_path(package_root)
    findings = uni = None
    cached_lock_graph = None
    cache_hit = False
    hashes = code_hash = None
    want_cache = not args.no_cache and not args.dump_lockgraph
    if want_cache:
        code_hash = cache_mod.code_fingerprint()
        hashes = cache_mod.module_hashes(package_root, extra_files)
        cached = cache_mod.load(cache_path)
        findings = cache_mod.lookup(cached, package_root, code_hash, hashes)
        if findings is not None:
            cache_hit = True
            cached_lock_graph = (cached or {}).get("lock_graph")
    if findings is None:
        findings, uni = run_analysis(package_root=args.root)
        if want_cache and hashes is not None:
            cache_mod.store(
                cache_path, package_root, code_hash, hashes, findings,
                dataflow.get(uni).module_summaries(),
                rules_locks.lock_graph_payload(uni),
            )

    if args.dump_lockgraph:
        payload = rules_locks.lock_graph_payload(uni)
        if args.dump_lockgraph.endswith(".dot"):
            with open(args.dump_lockgraph, "w", encoding="utf-8") as fh:
                fh.write(rules_locks.lock_graph_dot(payload))
        else:
            with open(args.dump_lockgraph, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=2, sort_keys=True)
                fh.write("\n")
        print(f"lock graph: {len(payload['nodes'])} locks, "
              f"{len(payload['edges'])} edges, "
              f"{len(payload['cycles'])} cycle(s) -> {args.dump_lockgraph}")
        return 0

    if args.fix_unused_pragmas:
        edits = pragmas.plan_unused_removals(findings, repo_root)
        if not edits:
            print("no unused pragmas to remove.")
            return 0
        for path, line_no, old, new in edits:
            rel = os.path.relpath(path, repo_root)
            if new is None:
                print(f"{rel}:{line_no}: delete line: {old.strip()}")
            else:
                print(f"{rel}:{line_no}: {old.strip()}  ->  {new.strip()}")
        if args.write:
            changed = pragmas.apply_removals(edits)
            print(f"applied: {changed} line(s) rewritten.")
        else:
            print(f"dry run: {len(edits)} line(s) would change "
                  "(re-run with --write to apply).")
        return 0

    baseline_path = args.baseline
    if baseline_path is None:
        default = os.path.join(_repo_root(), BASELINE_NAME)
        baseline_path = default if os.path.exists(default) else None

    if args.write_baseline:
        target = baseline_path or os.path.join(_repo_root(), BASELINE_NAME)
        baseline_mod.save(target, findings)
        print(f"baseline written: {len(findings)} grandfathered finding(s) -> {target}")
        return 0

    entries = baseline_mod.load(baseline_path) if baseline_path else []
    new, grandfathered, stale = baseline_mod.apply(findings, entries)

    blocking = new + stale
    for f in blocking:
        print(f.render())
    if grandfathered:
        print(f"({len(grandfathered)} grandfathered finding(s) suppressed by "
              f"{baseline_path})")

    if args.json:
        if uni is not None:
            lock_graph = rules_locks.lock_graph_payload(uni)
            modules_scanned = len(uni.modules)
        else:  # cache hit: the stored graph and hash map stand in
            lock_graph = cached_lock_graph
            modules_scanned = len(hashes or ())
        report = {
            "schema": REPORT_SCHEMA,
            "modules_scanned": modules_scanned,
            "cache_hit": cache_hit,
            "rules": sorted(rules.RULES),
            "rule_counts": _rule_counts(findings),
            # findings a pragma suppressed, by rule (None on a cache hit)
            "suppressed_counts": _rule_counts(uni.suppressed) if uni is not None else None,
            "new_findings": [f.as_dict() for f in new],
            "stale_baseline": [f.as_dict() for f in stale],
            "grandfathered": [f.as_dict() for f in grandfathered],
            "lock_graph": lock_graph,
        }
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")

    if blocking:
        print(f"FAIL: {len(new)} new finding(s), {len(stale)} stale baseline "
              "entr(y/ies). Fix them, pragma with a reason "
              "('ht: ignore' + [rule] + '-- why'), or --write-baseline.")
        return 1
    scanned = len(uni.modules) if uni is not None else len(hashes or ())
    print(f"OK: {scanned} modules clean "
          f"({len(grandfathered)} baselined)"
          f"{' [cache hit]' if cache_hit else ''}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
