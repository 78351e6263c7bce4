"""The CUDA kernels' machine code against another tree's: builds the other
tree's kernel sources with this tree's ``nvcc`` flags and compares
``cuobjdump -sass`` function by function.

``python -m dcs_net_tpu_torch.tools.compare_sass OTHER_ROOT [--out DIR]``

OTHER_ROOT is the root of another checkout (say ``git archive <commit> |
tar -x -C build/parent``); it needs the CUDA toolkit (``nvcc``,
``cuobjdump``, ``cu++filt``), so it runs on the machine with the card. For
each kernel source it prints how many of the other tree's float32 functions
and bf16 functions (a name holding ``bf16`` or ``bfloat16``) compile to the
same instructions here, names the ones that differ, and lists the functions
only this tree has. A function is matched by its demangled name without its
parameter list and with a ``float`` last template argument dropped (a kernel
templated on its element type keeps its float32 instance's name); the
instructions are compared without their addresses and encodings.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
from typing import Dict, List

SOURCES = ("conv_same.cu", "tapconv.cu", "stft.cu")


def short_name(demangled: str) -> str:
    """``void ns::k<(int)2, float>(const float *, ...)`` -> ``ns::k<(int)2>``."""
    depth = 0
    for i, ch in enumerate(demangled):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            demangled = demangled[:i]
            break
    return re.sub(r"^void ", "", demangled).replace(", float>", ">")


def sass(library: str, bindir: str) -> Dict[str, List[str]]:
    """{short name: the function's instructions} of a built library."""
    out = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass", library],
                         capture_output=True, text=True, check=True).stdout
    funcs: Dict[str, List[str]] = {}
    cur = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*(/\*.*)?$", line)
            if m and m.group(1):
                funcs[cur].append(m.group(1))
    names = list(funcs)
    demangled = subprocess.run([os.path.join(bindir, "cu++filt")], input="\n".join(names),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    return {short_name(d): funcs[n] for n, d in zip(names, demangled)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other", help="the root of the other tree")
    p.add_argument("--out", default=os.path.join("build", "compare_sass"),
                   help="where the other tree's libraries are built")
    args = p.parse_args(argv)

    from dcs_net_tpu_torch.dsp import stft_cuda  # noqa: F401  (registers kernel 1)
    from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv  # noqa: F401
    from dcs_net_tpu_torch.utils import cuda_lib

    cuda_lib.build_all()
    nvcc = cuda_lib.find_nvcc()
    bindir = os.path.dirname(nvcc)
    os.makedirs(args.out, exist_ok=True)
    other = {src: os.path.join(args.out, src + ".so") for src in SOURCES}
    procs = [subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, "-o", other[src],
                               os.path.join(args.other, "dcs_net_tpu_torch", "csrc", src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src in SOURCES]
    for src, proc in zip(SOURCES, procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the other tree's {src}:\n{log}")
    for src in SOURCES:
        here = next(str(k.library_path) for k in cuda_lib.KERNELS.values()
                    if k.source.name == src)
        old, new = sass(other[src], bindir), sass(here, bindir)
        parts = []
        for kind, names in (("float32", [n for n in old if not re.search("bf16|bfloat16", n)]),
                            ("bf16", [n for n in old if re.search("bf16|bfloat16", n)])):
            differ = sorted(n for n in names if old[n] != new.get(n))
            parts.append(f"{kind} functions identical {len(names) - len(differ)}/{len(names)}"
                         + (f" (differing: {', '.join(differ)})" if differ else ""))
        print(f"SASS {src}: " + "; ".join(parts)
              + f"; new here: {', '.join(sorted(set(new) - set(old))) or 'none'}", flush=True)


if __name__ == "__main__":
    main()
