#!/usr/bin/env python3
"""Count the SASS instructions of the port's kernels, by function and
opcode.

    python3 scripts/count_sass.py [--sources draw.cu,normal.cu]
        [--dump DIR]

Builds the named sources of ``src/repro_torch/kernels/csrc`` (nvcc, as the
kernels build at first use), disassembles each library with ``cuobjdump
-sass`` and prints one JSON line per kernel function: its demangled name,
its instruction count and the count of each opcode (the part of the
mnemonic before the first dot, predicates dropped).  The threefry hash's
count comes from reading the draw kernel's BITS form, whose loop is one
hash and one store.  ``--dump DIR`` also writes each function's SASS to a
file there.  Needs the CUDA toolkit (cuobjdump beside nvcc), no GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FUNCTION = re.compile(r"^\s*Function : (\S+)")
INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def tool(name: str) -> str:
    path = shutil.which(name)
    if path is None and Path(f"/usr/local/cuda/bin/{name}").exists():
        path = f"/usr/local/cuda/bin/{name}"
    if path is None:
        raise SystemExit(f"count_sass: {name} not found")
    return path


def functions(sass: str):
    """(mangled name, [lines]) for each function of a cuobjdump listing."""
    name, lines = None, []
    for line in sass.splitlines():
        m = FUNCTION.match(line)
        if m:
            if name is not None:
                yield name, lines
            name, lines = m.group(1), []
        elif name is not None:
            lines.append(line)
    if name is not None:
        yield name, lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sources", default="draw.cu,normal.cu")
    ap.add_argument("--dump", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    sources = [s for s in args.sources.split(",") if s]
    libs = _build.build(sources)
    cuobjdump, cufilt = tool("cuobjdump"), tool("cu++filt")
    dump = Path(args.dump) if args.dump else None
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
    for source in sources:
        sass = subprocess.run([cuobjdump, "-sass", str(libs[source])],
                              capture_output=True, text=True,
                              check=True).stdout
        for i, (mangled, lines) in enumerate(functions(sass)):
            ops = [m.group(1) for m in map(INSTRUCTION.match, lines) if m]
            ops = [op for op in ops if op != "NOP"]
            name = subprocess.run([cufilt, mangled], capture_output=True,
                                  text=True, check=True).stdout.strip()
            if dump is not None:
                (dump / f"{Path(source).stem}-{i}.sass").write_text(
                    name + "\n" + "\n".join(lines) + "\n")
            print(json.dumps({"source": source, "function": name,
                              "instructions": len(ops),
                              "opcodes": dict(collections.Counter(ops)
                                              .most_common())}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
