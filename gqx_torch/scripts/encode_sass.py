"""Registers, spills and instruction counts of the HSQ encode kernel.

    python -m gqx_torch.scripts.encode_sass [--dim 16] [--out DIR]

Compiles ``gqx_torch/csrc/hsq_encode.cu`` for sm_90a (the flags of
``gqx_torch.ops._build``) into a cubin with ptxas's report (``-Xptxas -v``)
and prints, for each kernel of the given dim, its registers, shared memory
and spills.  Then it disassembles the cubin (``cuobjdump -sass``) and, for
each loop that issues mma (HMMA), counts the loop's instructions by opcode:
the instructions the selection spends per mma in each of its two passes.
Needs the CUDA toolkit (nvcc, cuobjdump), no GPU.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import tempfile

from gqx_torch.ops import _build

_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(_build._nvcc()), name)


def _functions(sass: str):
    """{function name: [(address, instruction text)]} of a cuobjdump listing."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name is not None:
            m = _ADDR.search(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def _opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):     # a predicate guard
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def _loops(body):
    """(start, end) of each backward branch's range that holds an HMMA and
    no inner such range: the mma loops."""
    ranges = []
    for addr, text in body:
        m = _BRA.search(text)
        if m and int(m.group(1), 16) < addr:
            ranges.append((int(m.group(1), 16), addr))
    with_mma = [(a, b) for a, b in ranges
                if any(a <= x <= b and _opcode(t) == "HMMA" for x, t in body)]
    return sorted((a, b) for a, b in with_mma
                  if not any((c, d) != (a, b) and a <= c and d <= b for c, d in with_mma))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--out", default=None, help="directory for the cubin (default: a temporary one)")
    args = ap.parse_args()

    src = os.path.join(_build.CSRC_DIR, "hsq_encode.cu")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        cubin = os.path.join(out_dir, "hsq_encode.cubin")
        rep = subprocess.run([_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", cubin, src],
                             capture_output=True, text=True, check=True)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
    tag = f"ILi{args.dim}E"
    kernel = None
    for line in (rep.stderr + rep.stdout).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif kernel and tag in kernel and ("registers" in line or "spill" in line):
            print(f"[ptxas] {kernel}: {line.replace('ptxas info    :', '').strip()}")
    for name, body in _functions(sass).items():
        if tag not in name:
            continue
        total = collections.Counter(_opcode(t) for _, t in body)
        print(f"[sass] {name}: {len(body)} instructions, {total['HMMA']} HMMA")
        for i, (a, b) in enumerate(_loops(body)):
            ops = collections.Counter(_opcode(t) for x, t in body if a <= x <= b)
            n, mma = sum(ops.values()), ops["HMMA"]
            print(f"[sass]   mma loop {i} [{a:#x}, {b:#x}]: {n} instructions, {mma} HMMA, "
                  f"{n / mma:.2f} per HMMA; " + ", ".join(f"{k} {v}" for k, v in ops.most_common()))


if __name__ == "__main__":
    main()
