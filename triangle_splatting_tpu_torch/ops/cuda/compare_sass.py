"""Compare the machine code (SASS) of the kernels of two CUDA sources.

    python -m triangle_splatting_tpu_torch.ops.cuda.compare_sass OLD.cu [NEW.cu]

NEW defaults to ``csrc/blend.cu``. Both are compiled for ``sm_90a`` with
the flags of ``build.py`` into a cubin and disassembled with
``cuobjdump -sass``. Each kernel of OLD is matched to the kernel of NEW
with the same name, or, where NEW added a trailing ``bool`` template
parameter, to its ``false`` instantiation (``k`` to ``k<false>``,
``k<true>`` to ``k<true, false>``). For each pair the script prints both
ptxas resource lines and whether the two instruction streams are
identical, and exits 1 if any differs. It needs ``nvcc`` and
``cuobjdump`` (CUDA toolkit).
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

from .build import CSRC, NVCC_FLAGS, _nvcc

_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def kernel_name(mangled: str) -> str:
    """``blend_forward_kernel``, ``blend_forward_kernel<false>``,
    ``blend_forward_kernel<true, false>`` or ``scan_two_level_kernel<8>``
    from a mangled entry name: the length-prefixed source name that ends in
    ``_kernel``, then its bool or int template arguments."""
    # every digit run and each of its suffixes may be the length (a hash
    # before it may end in digits); the last name that parses is the
    # shortest, the one without the hash's tail
    found = None
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if re.fullmatch(r"[A-Za-z_]\w*_kernel", name):
            found = end, name
    if found is None:
        return mangled
    end, name = found
    args = re.match(r"I((?:L[bi]\d+E)+)E", mangled[end + len(name):])
    if args is None:
        return name
    vals = [{"b0": "false", "b1": "true"}.get(t + v, v)
            for t, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
    return f"{name}<{', '.join(vals)}>"


def counterpart(name: str) -> str:
    """The name of ``name``'s instantiation with one more, trailing,
    ``false`` bool template argument."""
    if name.endswith(">"):
        return name[:-1] + ", false>"
    return name + "<false>"


def compile_sass(src: Path, cubin: Path) -> tuple[dict, dict]:
    """(kernel -> instruction list, kernel -> ptxas resource line)."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    log = subprocess.run([_nvcc(), *flags, "-cubin", "-o", str(cubin), str(src)],
                         capture_output=True, text=True, check=True)
    usage, name = {}, None
    for ln in (log.stdout + log.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif name is not None and "Used" in ln:
            usage[name] = ln.split(":", 1)[-1].strip()
    cuobjdump = str(Path(_nvcc()).with_name("cuobjdump"))
    dump = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    sass, name = {}, None
    for ln in dump.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_name(m.group(1))
            sass[name] = []
        elif name is not None:
            i = _INSN.search(ln)
            if i:
                sass[name].append(i.group(1))
    return sass, usage


def main(argv: list[str]) -> int:
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    old_src = Path(argv[0])
    new_src = Path(argv[1]) if len(argv) == 2 else CSRC / "blend.cu"
    with tempfile.TemporaryDirectory() as tmp:
        old, old_use = compile_sass(old_src, Path(tmp) / "old.cubin")
        new, new_use = compile_sass(new_src, Path(tmp) / "new.cubin")
    differ = 0
    for k, insns in sorted(old.items()):
        k_new = k if k in new else counterpart(k)
        if k_new not in new:
            print(f"{k}: no counterpart in {new_src.name}")
            differ += 1
            continue
        same = insns == new[k_new]
        differ += not same
        first = next((i for i, (a, b) in enumerate(zip(insns, new[k_new])) if a != b),
                     min(len(insns), len(new[k_new])))
        print(f"{k} ({old_src.name}) vs {k_new} ({new_src.name}): "
              f"{len(insns)} vs {len(new[k_new])} instructions, "
              + ("identical" if same else f"differ from instruction {first}"))
        print(f"  ptxas {old_src.name}: {old_use.get(k)}")
        print(f"  ptxas {new_src.name}: {new_use.get(k_new)}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
