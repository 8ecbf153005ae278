"""K1's instantiations in two trees, compared function by function in SASS.

Run where the CUDA toolkit is (``nvcc``, ``cuobjdump``), from the root of
this repository:

    python tardis_torch/benchmarks/sass_diff.py --tree A --tree B

Each tree (the root of a checkout, or a ``git archive`` of an earlier
commit) builds with its own ``tardis_torch`` the K1 instantiations that
the classic paths launch (``VARIANTS``, each with and without line
estimators), all trees' at once.  Each instantiation prints one JSON line:
per tree its ptxas register and spill lines and, per kernel function, its
instruction count and a hash of its SASS (predicates, opcodes and
operands; addresses, encodings and the tag of the file's anonymous
namespace dropped), whether every tree's code is the same (``"same":
true``), and where the first and the last tree's code first differ.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

# the option sets of the classic paths' K1 launches (kernel.OPTIONS names)
VARIANTS = {
    "main": (),
    "v_inner": ("last_interaction",),
    "options": ("tracker", "reflective", "weights"),
    "walk": ("walk",),
    "relativity": ("full_relativity", "last_interaction", "weights"),
}

_BUILD = """
import json, sys
from tardis_torch import cuda
from tardis_torch.transport import kernel
variants = json.loads(sys.argv[1])
libs = {}
for name, on in variants.items():
    for le in (False, True):
        flags = tuple(o in on or (o == "line_estimators" and le)
                      for o in kernel.OPTIONS)
        libs[f"{name} le={int(le)}"] = ("transport_loop",
                                        kernel.library_defines(flags))
cuda.build(list(libs.values()))
print(json.dumps({k: str(cuda.library_path(*v)) for k, v in libs.items()}))
"""


def this_checkout_smoke():
    """This checkout's ``chip_smoke.py`` (its SASS parser)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("sass_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the tag of a source file's anonymous namespace, which differs between
# two versions of the file whatever their code
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def functions(smoke, tool, lib):
    """{function: its instructions, each "predicated opcode operands"} of
    the library ``lib``, anonymous-namespace tags dropped."""
    text = _ANON.sub("_GLOBAL__N__", subprocess.run(
        [tool, "-sass", lib], capture_output=True, text=True, check=True,
        timeout=300).stdout)
    return {name: [f"{int(p)} {op} {args}" for _, p, op, args in code]
            for name, code in smoke.sass_functions(text).items()}


def summary(code):
    """Instruction count and hash of each function."""
    return {name: (len(body), hashlib.sha256(
        "\n".join(body).encode()).hexdigest()[:16])
        for name, body in code.items()}


def first_difference(a, b):
    """Per function that differs: the first index where the two trees'
    instructions differ, and both instructions there."""
    out = {}
    for name in a.keys() & b.keys():
        for i, (x, y) in enumerate(zip(a[name], b[name])):
            if x != y:
                out[name] = (i, x, y)
                break
        else:
            if len(a[name]) != len(b[name]):
                out[name] = (min(len(a[name]), len(b[name])), None, None)
    return out


def main(trees):
    smoke = this_checkout_smoke()
    sys.path.insert(0, os.path.dirname(os.path.abspath(smoke.__file__)))
    from tardis_torch import cuda

    tool = os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD, json.dumps(VARIANTS)], cwd=tree,
        stdout=subprocess.PIPE, text=True) for tree in trees]
    paths = []
    for tree, proc in zip(trees, procs):
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the build failed in {tree}")
        paths.append(json.loads(out.strip().splitlines()[-1]))
    for label in paths[0]:
        per_tree, codes = {}, []
        for tree, built in zip(trees, paths):
            lib = built[label]
            log = os.path.splitext(lib)[0] + ".log"
            with open(log) as f:
                ptxas = [ln.strip() for ln in f
                         if "registers" in ln or "spill" in ln]
            codes.append(functions(smoke, tool, lib))
            per_tree[tree] = dict(ptxas=ptxas, functions=summary(codes[-1]))
        print(json.dumps(dict(
            phase="sass_diff", instantiation=label,
            same=all(c == codes[0] for c in codes), trees=per_tree,
            first_difference=first_difference(codes[0], codes[-1]))),
            flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True)
    args = ap.parse_args()
    main([os.path.abspath(t) for t in args.tree])
