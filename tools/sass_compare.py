#!/usr/bin/env python3
"""Compare the machine code (SASS) of two versions of one kernel source,
kernel by kernel, on a machine with the CUDA toolkit.

    python3 tools/sass_compare.py OLD.cu NEW.cu [--out DIR] [--new-defines "-DNAME=VALUE ..."]

Each source is compiled with the port's own flags (``build.NVCC_FLAGS``,
``-cubin`` in place of ``-shared``; NEW with ``--new-defines``, by default
none, so that the flash source builds every element type; with
``-DFLASH_ELEM=<code>`` one library's, as the port loads it) for sm_90a.  Every kernel of OLD is paired
with the kernel of NEW of the same name and template arguments; where NEW
added template arguments at the end, with the instance whose added
arguments are ``float`` or ``false`` (the float32 instance of a kernel
that gained an element type), or else ``__nv_bfloat16`` (a bfloat16-only
kernel that gained one); where a ``bool`` bfloat16 flag became the
element type, with the instance whose flag ``true`` / ``false`` reads
``__nv_bfloat16`` / ``float``.  For each pair one JSON line:
registers, stack frame and spill bytes as ptxas reports them, the count
of SASS instructions of each, and how many instruction lines differ
(addresses and encodings left out; 0: the same code); then one line for
each kernel of NEW that no kernel of OLD pairs with (a bfloat16
instance, say), with its resources and instruction count.  With
``--out`` each version's SASS is written there as well.  Exits non-zero without
``nvcc``.
"""
from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

PREFERRED = ("float", "false", "(bool)0")  # the added template arguments of a float32 instance
BF16_ONLY = ("__nv_bfloat16",)  # ... of a kernel whose old instances were bfloat16 only
# A bfloat16 flag that became the element type: its old value -> the type.
FLAG_TO_TYPE = {"true": "__nv_bfloat16", "(bool)1": "__nv_bfloat16", "false": "float",
                "(bool)0": "float"}


def tool(nvcc: str, name: str) -> str:
    path = os.path.join(os.path.dirname(nvcc), name)
    return path if os.path.exists(path) else name


def compile_cubin(nvcc: str, flags, source: str, out: str) -> str:
    """ptxas's report for ``source`` built into ``out``."""
    flags = ["-cubin" if f == "-shared" else f for f in flags if f not in ("-Xcompiler", "-fPIC")]
    proc = subprocess.run([nvcc, *flags, "-o", out, source], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def demangle(nvcc: str, names):
    proc = subprocess.run([tool(nvcc, "cu++filt")], input="\n".join(names), capture_output=True,
                          text=True, check=True)
    return dict(zip(names, proc.stdout.splitlines()))


def resources(report: str):
    """{mangled name: {registers, stack, spill_stores, spill_loads}} from
    ptxas's -v report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sass(nvcc: str, cubin: str):
    """{mangled name: [instruction text]} from ``cuobjdump -sass``."""
    text = subprocess.run([tool(nvcc, "cuobjdump"), "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*(/\*.*\*/)?\s*$", line)
        if m and name and m.group(1):
            out[name].append(re.sub(r"\s+", " ", m.group(1)).rstrip(" ;"))
    return out


def split(demangled: str):
    """(base name, template arguments) of a demangled kernel name."""
    m = re.match(r"(.*?)<(.*)>\s*\(", demangled)
    if not m:
        return demangled, []
    depth, args, cur = 0, [], ""
    for ch in m.group(2):
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
            continue
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        cur += ch
    args.append(cur.strip())
    return m.group(1), args


def pair(old_names, new_names):
    """[(old, new)] demangled-name pairs (see the module's note)."""
    pairs = []
    new_split = {n: split(n) for n in new_names}
    for old in old_names:
        base, args = split(old)
        same = [n for n, (b, a) in new_split.items() if b == base and a == args]

        def longer(added):
            return [n for n, (b, a) in new_split.items()
                    if b == base and a[:len(args)] == args and len(a) > len(args)
                    and all(x in added for x in a[len(args):])]

        typed = [FLAG_TO_TYPE.get(x, x) for x in args]
        renamed = [n for n, (b, a) in new_split.items() if b == base and a == typed != args]
        found = same or longer(PREFERRED) or longer(BF16_ONLY) or renamed
        pairs.append((old, found[0] if len(found) == 1 else None))
    return pairs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out", default=None)
    ap.add_argument("--new-defines", default="",
                    help="nvcc -D flags for NEW, space-separated (e.g. -DFLASH_ELEM=1: the "
                         "flash library of one element type, as ops.py builds it)")
    args = ap.parse_args()
    from repro_torch.kernels import build

    try:
        nvcc = build.nvcc_path()
    except RuntimeError as err:
        print(f"sass_compare: {err}", file=sys.stderr)
        return 1
    versions = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, source, defines in (("old", args.old, []),
                                       ("new", args.new, args.new_defines.split())):
            cubin = os.path.join(tmp, f"{label}.cubin")
            report = compile_cubin(nvcc, [*build.NVCC_FLAGS, *defines], source, cubin)
            res, code = resources(report), sass(nvcc, cubin)
            names = demangle(nvcc, sorted(code))
            versions[label] = {names[m]: (res.get(m, {}), code[m]) for m in code}
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                stem = os.path.splitext(os.path.basename(source))[0]
                with open(os.path.join(args.out, f"{stem}.{label}.sass"), "w") as f:
                    for name, (_, lines) in sorted(versions[label].items()):
                        f.write(f"// {name}\n" + "\n".join(lines) + "\n")
    old, new = versions["old"], versions["new"]
    pairs = pair(sorted(old), sorted(new))
    for o, n in pairs:
        row = {"old": o, "new": n, "old_resources": old[o][0],
               "old_instructions": len(old[o][1])}
        if n is not None:
            diff = [d for d in difflib.unified_diff(old[o][1], new[n][1], lineterm="", n=0)
                    if d[:1] in "+-" and d[:3] not in ("+++", "---")]
            row.update(new_resources=new[n][0], new_instructions=len(new[n][1]),
                       lines_differing=len(diff), same_code=not diff)
        print(json.dumps(row), flush=True)
    paired = {n for _, n in pairs}
    for n in sorted(set(new) - paired):
        print(json.dumps({"new_only": n, "resources": new[n][0], "instructions": len(new[n][1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
