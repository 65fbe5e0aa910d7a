"""The loops of the port's kernels in the built library, read from the SASS
that ``cuobjdump`` prints: an issue count per cell for kernels bound by
their instructions.

    python -m proxtpu_torch.tools.sass_loops [NAME ...]

For every kernel whose mangled name holds one of the NAMEs (default
``cp_band_kernel``), prints its size and each innermost loop (a branch back
to an earlier address, with no other such branch inside): its length in
instructions, the IEEE division checks (``FCHK``) and multi-function-unit
instructions (``MUFU``: reciprocals and square roots) in it.  A cell of
``cp_k_steps`` takes one division in the primal half and one square root in
the dual half, so a loop's length over its ``FCHK`` (primal) or its
``MUFU.RSQ`` (dual) count is the instructions a cell costs in that half,
unrolled or not; their sum is I, the instructions of a cell and step.
Instructions behind a branch not taken (a division's slow path, the
projection where the norm is under lam) are counted where they lie inside
the loop, so I is an upper bound of what a thread issues.

Needs ``cuobjdump`` (CUDA_HOME) and builds the library if needed; no GPU.
"""

import re
import subprocess
import sys
from pathlib import Path

from proxtpu_torch.kernels import _build

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))")


def functions(sass):
    """``{name: [(address, text)]}`` and ``{name: {label: address}}``."""
    code, labels, name, pending = {}, {}, None, []
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            code[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.match(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[name][label] = addr
            pending = []
            code[name].append((addr, m.group(2).strip()))
    return code, labels


def loops(insns, labels):
    """The innermost loops: ``(first, last)`` index pairs into ``insns``."""
    index = {addr: k for k, (addr, _) in enumerate(insns)}
    back = []
    for k, (addr, text) in enumerate(insns):
        m = _TARGET.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr and target in index:
            back.append((index[target], k))
    return [(a, b) for a, b in back
            if not any(a <= c and d <= b and (c, d) != (a, b)
                       for c, d in back)]


def main():
    names = sys.argv[1:] or ["cp_band_kernel"]
    lib = _build.build_dir() / "libproxtpu_torch.so"
    if not lib.exists():
        _build.library()
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    code, labels = functions(sass)
    for name, insns in code.items():
        if not any(n in name for n in names):
            continue
        print(f"{name}: {len(insns)} instructions")
        for a, b in loops(insns, labels[name]):
            body = [text for _, text in insns[a:b + 1]]
            fchk = sum("FCHK" in t for t in body)
            rsq = sum("MUFU.RSQ" in t for t in body)
            mufu = sum("MUFU" in t for t in body)
            cells = max(fchk, rsq, 1)
            print(f"  loop at {insns[a][0]:#06x}..{insns[b][0]:#06x}: "
                  f"{len(body)} instructions, FCHK {fchk}, MUFU {mufu} "
                  f"(RSQ {rsq}): {len(body) / cells:.1f} per "
                  f"{'cell' if fchk or rsq else 'iteration'}")


if __name__ == "__main__":
    main()
