"""Compare the machine code that two checkouts compile from one CUDA source.

Builds ``difffacto_torch/csrc/<source>.cu`` in each checkout (each with its
own ``ops/_build.py``, into its own ``build/kernels/``), disassembles both
libraries with ``cuobjdump -sass`` and, for every kernel of the first,
finds the kernel of the second with the same template arguments (a
template flag the first lacks counts as false) and says whether their
instruction lists are identical, with their lengths, and the hot loop of
each: the innermost backward branch whose body holds the most special-function
(MUFU) instructions, with its length and its MUFU instructions by kind (in
the EMD kernel, the Sinkhorn sweep's unrolled loop: one MUFU.SQRT an
element). Kernels only the second has are listed. Needs the CUDA toolkit
(``nvcc``, ``cuobjdump``).

    python3 tools/sass_diff_torch.py --roots OLD NEW [--source fused_core]
"""

import argparse
import json
import os
import re
import subprocess
import sys


def library(root, source):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from difffacto_torch.ops import _build; "
            "_build.build([sys.argv[2]]); print(_build.library_path(sys.argv[2])); "
            "print(_build.nvcc())")
    out = subprocess.run([sys.executable, "-c", code, root, source], capture_output=True,
                         text=True, check=True, timeout=900).stdout.split()
    return out[-2], out[-1]


INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*;)")


def hot_loop(body):
    """The innermost loop (a backward branch and the instructions from its
    target to it) with the most MUFU instructions: its length and its MUFU
    instructions by kind; None where no loop holds one."""
    code = [(int(m.group(1), 16), m.group(2).strip()) for m in INSTRUCTION.finditer(body)]
    spans = []
    for addr, text in code:
        target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) <= addr:
            spans.append((int(target.group(1), 16), addr))
    best = None
    for lo, hi in spans:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue  # holds another loop: not innermost
        loop = [t for a, t in code if lo <= a <= hi]
        mufu = {}
        for t in loop:
            op = re.search(r"MUFU\.(\w+)", t)
            if op:
                mufu[op.group(1)] = mufu.get(op.group(1), 0) + 1
        rank = (sum(mufu.values()), -len(loop))
        if mufu and (best is None or rank > best[0]):
            best = (rank, dict(instructions=len(loop), mufu=mufu))
    return best[1] if best else None


def kernels(lib, nvcc):
    """{key: (instructions, hot loop)} of every function in ``lib``; the key
    is the kernel's name with its template arguments read from the mangled
    name."""
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        base = re.search(r"\d+([a-z_]+kernel)", name)
        mode = re.search(r"ModeE(\d+)", name)
        flag = re.search(r"ModeE\d+ELb(\d)", name)
        smem = re.search(r"kernelILb(\d)", name)  # emd_hybrid_kernel<SMEM>
        key = "{}<mode {}, tail {}>".format(base.group(1) if base else name.strip(),
                                           mode.group(1) if mode else "-",
                                           flag.group(1) if flag else "0")
        if smem:
            key = "{}<{}>".format(base.group(1), "true" if smem.group(1) == "1" else "false")
        out[key] = ([m.group(2).strip() for m in INSTRUCTION.finditer(body)], hot_loop(body))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs=2, required=True, metavar=("OLD", "NEW"))
    ap.add_argument("--source", default="fused_core")
    args = ap.parse_args(argv)
    (old, nvcc), (new, _) = (library(os.path.abspath(r), args.source) for r in args.roots)
    a, b = kernels(old, nvcc), kernels(new, nvcc)
    none = ([], None)
    report = {k: dict(instructions_old=len(v), instructions_new=len(b.get(k, none)[0]),
                      identical=v == b.get(k, none)[0], loop_old=loop,
                      loop_new=b.get(k, none)[1]) for k, (v, loop) in a.items()}
    report.update({k: dict(instructions_new=len(v), loop_new=loop, only_in_new=True)
                   for k, (v, loop) in b.items() if k not in a})
    for k, r in report.items():
        print(f"{args.source} {k}: {r}")
    print(json.dumps({"sass_diff": args.source, "kernels": report}))
    return report


if __name__ == "__main__":
    main()
