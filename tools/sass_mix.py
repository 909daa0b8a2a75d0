#!/usr/bin/env python3
"""Build CUDA sources with the package's nvcc flags and print each kernel instance's SASS
opcode mix (``cuobjdump -sass``), one JSON line per source.

    python3 tools/sass_mix.py SOURCE.cu [SOURCE.cu ...] [--dump DIR [--match TEXT]]
    python3 tools/sass_mix.py --read FILE.sass [FILE.sass ...]

Each source is built as ``heat_tpu_torch.core.kernels._nvcc.build`` builds the package's
kernels (into the package's ``_build/``, keyed by the source and the headers beside it),
all at once. A kernel's line gives its static instruction count and the count of each
opcode (the mnemonic before its first dot, predicates dropped), with the ptxas registers
and spill bytes from the build log, and the same for the body of its largest loop (from a
backward branch's target to the branch: the main loop of a flash kernel, one tile).
``--dump DIR`` also writes the SASS of each kernel instance whose name contains ``--match``
(every instance without it) there, one file each; ``--read`` gives the counts of such
files without building anything. Needs the CUDA toolkit (nvcc and cuobjdump); runs without a card.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from heat_tpu_torch.core.kernels import _nvcc  # noqa: E402
from heat_tpu_torch.core.kernels._measure import ptxas_summary, sass, sass_counts  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="*", type=Path)
    parser.add_argument("--dump", type=Path, default=None, help="write kernel instances' SASS here")
    parser.add_argument("--match", default="", help="dump only instances whose name contains this")
    parser.add_argument("--read", nargs="+", type=Path, default=[], help="count dumped SASS files instead")
    args = parser.parse_args()
    for f in args.read:
        print(json.dumps({"file": str(f), **sass_counts(f.read_text().splitlines())}), flush=True)
    if not args.sources:
        return 0
    sources = [s.resolve() for s in args.sources]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = list(pool.map(_nvcc.build, sources))
    for source, b in zip(sources, builds):
        ptxas = {row[0]: row[1:] for row in ptxas_summary(b["log"])}
        kernels = {}
        for name, lines in sass(b["path"]).items():
            if args.dump is not None and args.match in name:
                where = args.dump / b["path"].stem  # the library's name: its source's and its hash
                where.mkdir(parents=True, exist_ok=True)
                (where / (re.sub(r"[^A-Za-z0-9_]+", "_", name).strip("_") + ".sass")).write_text("\n".join(lines))
            regs, spill_st, spill_ld = ptxas.get(name, (None, None, None))
            kernels[name] = {"registers": regs, "spill_stores": spill_st, "spill_loads": spill_ld, **sass_counts(lines)}
        print(json.dumps({"source": str(source.relative_to(ROOT)) if source.is_relative_to(ROOT) else str(source),
                          "nvcc_s": b["seconds"], "kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
