#!/usr/bin/env python3
"""Compare the PTX that nvcc makes of the fused kernel in two checkouts,
kernel by kernel: how a change shows that it leaves an instantiation's
code as it was.

    python3 tools/compare_ptx.py PARENT_ROOT CHANGE_ROOT [--out DIR]
        [--source FILE ...]

Compiles each CUDA library of the fused kernel (``_build.CUDA_LIBRARIES``
of ``CHANGE_ROOT`` but ``riccati``, or the ``--source`` files named) of
both checkouts to PTX with the
flags ``_build.py`` builds them with (``-ptx`` in place of ``-shared``),
one nvcc a file, all at once, into DIR (default: a temporary directory),
splits each into its ``.entry`` functions and prints one JSON line a
kernel: its library, its mangled name, and whether its text is the same in
both (``null`` where only one checkout has it), after the names that
depend only on a function's place in the file are made independent of it
(the basic-block labels ``$L__BB<function>_<block>`` and the local depot
``__local_depot<function>``); for a kernel that differs, the number of
lines of a unified diff and its first lines.  The last line sums them
up.  Needs ``nvcc`` (``/usr/local/cuda/bin`` or on PATH); builds nothing
that the package loads.  Exits 1 when a kernel that both checkouts have
differs.
"""

import argparse
import concurrent.futures
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ENTRY = re.compile(r"^\.visible \.entry (\S+)\(", re.M)
# Names numbered by the function's place in the file.
PLACE = (re.compile(r"\$L__BB\d+_"), re.compile(r"__local_depot\d+"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def entries(ptx: str) -> dict:
    """{kernel name: its text} of one PTX file."""
    starts = [(m.start(), m.group(1)) for m in ENTRY.finditer(ptx)]
    out = {}
    for i, (at, name) in enumerate(starts):
        end = starts[i + 1][0] if i + 1 < len(starts) else len(ptx)
        text = ptx[at:end]
        text = PLACE[0].sub("$L__BB_", text)
        out[name] = PLACE[1].sub("__local_depot", text)
    return out


def compile_ptx(root: Path, source: str, out: Path) -> Path:
    csrc = root / "mahi_mpc_tpu_torch" / "csrc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3"]
    subprocess.run([nvcc(), *flags, "-ptx", "-I", str(csrc),
                    str(csrc / source), "-o", str(out)], check=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--out", default=None)
    ap.add_argument("--source", nargs="*", default=None,
                    help="csrc files to compile (default: every fused "
                         "library's)")
    args = ap.parse_args()
    roots = {"parent": Path(args.parent).resolve(),
             "change": Path(args.change).resolve()}
    sys.path.insert(0, str(roots["change"]))
    from mahi_mpc_tpu_torch._build import CUDA_LIBRARIES

    sources = args.source or [src for name, (src, _) in
                              CUDA_LIBRARIES.items() if name != "riccati"]
    out = Path(args.out or tempfile.mkdtemp(prefix="ptx_"))
    out.mkdir(parents=True, exist_ok=True)
    jobs = {(side, src): out / f"{side}_{Path(src).stem}.ptx"
            for side in roots for src in sources}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futures = {key: ex.submit(compile_ptx, roots[key[0]], key[1], path)
                   for key, path in jobs.items()}
        for f in futures.values():
            f.result()
    same = differ = only = 0
    for src in sources:
        texts = {side: entries(jobs[side, src].read_text()) for side in roots}
        for name in sorted(set(texts["parent"]) | set(texts["change"])):
            a, b = texts["parent"].get(name), texts["change"].get(name)
            equal = None if a is None or b is None else a == b
            same += equal is True
            differ += equal is False
            only += equal is None
            line = dict(library=src, kernel=name, same_ptx=equal,
                        in_parent=a is not None, in_change=b is not None)
            if equal is False:
                diff = list(difflib.unified_diff(
                    a.splitlines(), b.splitlines(), lineterm="", n=0))
                line.update(lines=[a.count("\n"), b.count("\n")],
                            diff_lines=len(diff), diff_head=diff[:40])
            print(json.dumps(line))
    print(json.dumps(dict(same=same, differ=differ, in_one_only=only,
                          ptx_dir=str(out))))
    return 1 if differ else 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
