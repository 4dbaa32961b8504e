"""Count the instructions of each loop in a kernel's SASS.

Run on the output of ``cuobjdump -sass`` for one of the port's kernel
libraries (``build/odometry_torch/lib<name>-<hash>.so`` after a build):

    /usr/local/cuda/bin/cuobjdump -sass build/odometry_torch/libdisparity_band-<hash>.so > b1.sass
    python3 tools/sass_loops.py b1.sass --function band_kernelILb1E

For every function whose mangled name contains ``--function``, each backward
branch closes a loop; the script prints the loop's address range, its
instruction count (static: every instruction between the branch target and
the branch, including those only some iterations take), its float32
arithmetic (FADD, FMUL, FFMA), shared-memory loads and atomics, and the most
frequent opcodes. Loops shorter than ``--min`` instructions are skipped.
"""

from __future__ import annotations

import argparse
import collections
import re
import sys

_INSTR = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def _opcode(text: str) -> str:
    words = text.split()
    if words[0].startswith("@"):  # predicate guard
        words = words[1:]
    return words[0].split(".")[0]


def loops(function_text: str, min_len: int):
    """(start, end, Counter of opcodes) of each loop of one function's SASS."""
    instrs = [(int(m.group(1), 16), m.group(2))
              for m in map(_INSTR.match, function_text.split("\n")) if m]
    index = {addr: i for i, (addr, _) in enumerate(instrs)}
    for i, (addr, text) in enumerate(instrs):
        m = _TARGET.search(text)
        if m is None:
            continue
        target = int(m.group(1), 16)
        if target < addr and target in index and i + 1 - index[target] >= min_len:
            body = instrs[index[target]: i + 1]
            yield target, addr, collections.Counter(_opcode(t) for _, t in body)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sass", help="output of cuobjdump -sass")
    ap.add_argument("--function", default="", help="part of the mangled function name")
    ap.add_argument("--min", type=int, default=30, help="shortest loop shown")
    args = ap.parse_args()
    with open(args.sass) as f:
        text = f.read()
    for function in re.split(r"\n\s+Function : ", text)[1:]:
        name = function.split("\n", 1)[0].strip()
        if args.function not in name:
            continue
        print(name)
        for start, end, ops in loops(function, args.min):
            fp = ops["FADD"] + ops["FMUL"] + ops["FFMA"]
            print(f"  loop {start:#06x}-{end:#06x}: {sum(ops.values())} instructions, float32 {fp}, "
                  f"LDS {ops['LDS']}, ATOMS {ops['ATOMS']}; {ops.most_common(8)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
