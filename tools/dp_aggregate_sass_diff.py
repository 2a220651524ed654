#!/usr/bin/env python3
"""Compare the SASS of two builds of the dp_aggregate kernels, kernel by kernel.

    python3 tools/dp_aggregate_sass_diff.py OTHER_TREE

Builds (or reuses) the dp_aggregate library of this tree and of OTHER_TREE (a
``git archive`` of another commit), disassembles both with ``cuobjdump -sass``
and, for each aggregation kernel (mode, pairs) and the noise-only kernel,
prints whether the instruction streams are identical once addresses and
encodings are dropped, else how many instructions each has and how many
differ.  A kernel instantiated with a trailing ``bool`` template argument
(the gated instance) is matched by its ungated (``false``) instance.  Needs
the CUDA toolkit (nvcc, cuobjdump); no card is used.
"""
from __future__ import annotations

import difflib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

KERNEL = re.compile(r"aggregate_kernelILi(\d)ELi(\d+)E(Lb([01])E)?E")


def build(tree: Path) -> str:
    """The tree's dp_aggregate library, built by its own wrapper."""
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.kernels.dp_aggregate import ops; print(ops.load_library()._name)"],
        cwd=tree, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def kernels(lib: str) -> dict[str, list[str]]:
    """Instruction text of each kernel in ``lib``, keyed by (mode, pairs, gated)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            m = KERNEL.search(name)
            key = (f"{m.group(1)}/{m.group(2)}/{m.group(4) or '0'}" if m
                   else "noise" if "noise_kernel" in name else None)
            if key is not None:
                out[key] = []
        elif key is not None:
            text = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split("/*")[0].strip()
            if text and not text.startswith(".") and text != "{" and text != "}":
                out[key].append(" ".join(text.replace(";", "").split()))
    return out


def main() -> int:
    here, other = Path(__file__).resolve().parents[1], Path(sys.argv[1]).resolve()
    mine, theirs = kernels(build(here)), kernels(build(other))
    report = {}
    for key, ins in sorted(theirs.items()):
        got = mine.get(key)
        if got is None:
            report[key] = "missing in this tree"
            continue
        differ = sum(1 for op in difflib.SequenceMatcher(None, ins, got, autojunk=False)
                     .get_opcodes() if op[0] != "equal")
        report[key] = ("identical" if ins == got else
                       f"{len(ins)} vs {len(got)} instructions, {differ} differing runs")
    print(json.dumps({"other": str(other), "kernels": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
