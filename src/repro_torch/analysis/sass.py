"""Read the compiled kernels' SASS: the instruction mix by SM pipe.

    python -m repro_torch.analysis.sass LIBRARY.so [--kernel NAME]

``cuobjdump -sass`` of a library built from ``csrc/`` (``kernels/_build``)
gives each kernel's static instruction mix (:func:`sass_mix`, the whole
function) and, for the site loops, the instructions per site update
(:func:`site_loops`): every innermost loop (a backward branch with no
other backward branch inside it) that loads from and stores to shared
memory and loads nothing from device memory, its instructions counted
once, divided by the int8 cells it stores a pass
(a 1-byte store is one site, a 4-byte store four).  That is the issue
cost of one site in the loop's steady state; the instructions outside
the loop (loads, barriers, stores to device memory) are not in it.  A
kernel that updates device memory in place (``stencil_update``) has its
site loop there instead: ``memory="global"`` takes the loops that load
from and store to device memory and touch no shared memory.  The CLI
prints one line a loop.  It needs the CUDA toolkit's ``cuobjdump``
beside ``nvcc``.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

#: SASS opcodes (before the first '.') of each pipe; what is not listed
#: counts as "other"
SASS_PIPES = {
    "fma": ("IMAD", "IMUL", "FFMA", "FMUL", "FADD"),
    "alu": ("LOP3", "IADD3", "ISETP", "FSETP", "SEL", "FSEL", "SHF", "LEA",
            "PRMT", "IMNMX", "PLOP3"),
    "xu": ("I2F", "F2I", "F2F", "MUFU"),
    "lsu": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL"),
    "tensor": ("HMMA",),
}
_PIPE_OF = {op: pipe for pipe, ops in SASS_PIPES.items() for op in ops}
#: bytes of a store by its width suffix (4 where it has none)
_STORE_BYTES = {"U8": 1, "S8": 1, "U16": 2, "S16": 2, "64": 8, "128": 16}
#: (load, store) opcodes of a site loop's memory, and those it must not
#: hold
_LOOP_MEMORY = {"shared": (("LDS", "STS"), "LDG"),
                "global": (("LDG", "STG"), "LDS")}

_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def disassemble(library_path, compiler: str) -> str:
    """``cuobjdump -sass`` of a built library; ``compiler`` is the path of
    the ``nvcc`` beside which ``cuobjdump`` lies."""
    cuobjdump = str(Path(compiler).with_name("cuobjdump"))
    return subprocess.run([cuobjdump, "-sass", str(library_path)],
                          check=True, capture_output=True, text=True).stdout


def _functions(sass: str):
    """``(name, body)`` of each kernel; a template instance's name
    carries its arguments: kernelIaLi64ELi128EE -> <a,64,128> (a: int8,
    t: 16-bit bf16 pattern), kernelILb1EE -> <true>, kernelILb1ELb0EE ->
    <true,false>, kernelILi4ELb0ELb1EE -> <4,false,true>."""
    for chunk in sass.split("Function : ")[1:]:
        found = re.search(r"([a-z][a-z_]*_kernel)"
                          r"(?:I((?:Li\d+E|Lb\dE|[a-z])+)E)?", chunk)
        args = [("true" if tok == "Lb1E" else "false") if tok[:2] == "Lb"
                else tok[2:-1] if tok[:2] == "Li" else tok
                for tok in re.findall(r"Li\d+E|Lb\dE|[a-z]",
                                      found.group(2) or "")]
        yield found.group(1) + (f"<{','.join(args)}>" if args else ""), chunk


def _pipe(op: str) -> str:
    return _PIPE_OF.get(op.split(".")[0], "other")


def sass_mix(sass: str) -> dict:
    """``{kernel: {pipe: count}}`` of the SASS instructions in each
    kernel (static counts, whole function)."""
    mix = {}
    for name, body in _functions(sass):
        counts = collections.Counter(
            _pipe(m.group(2)) for m in _INSTRUCTION.finditer(body))
        mix[name] = dict(sorted(counts.items()))
    return mix


def _store_bytes(op: str) -> int:
    return next((_STORE_BYTES[p] for p in op.split(".")[1:]
                 if p in _STORE_BYTES), 4)


def site_loops(sass: str, kernel: str = "", memory: str = "shared") -> list:
    """The site loops (as the module says) of each kernel whose name
    holds ``kernel``, over ``memory`` ("shared" or "global"): dicts of
    the kernel, the loop's address range, its instructions, the sites it
    stores a pass, and per site the count by pipe and by opcode."""
    (load, store), barred = _LOOP_MEMORY[memory]
    out = []
    for name, body in _functions(sass):
        if kernel not in name:
            continue
        code = [(int(m.group(1), 16), m.group(2), m.group(3))
                for m in _INSTRUCTION.finditer(body)]
        labels = {}
        for m in re.finditer(r"(\.L_x_\d+):\s*\n\s*/\*([0-9a-f]{4,})\*/",
                             body):
            labels[m.group(1)] = int(m.group(2), 16)
        back = []
        for addr, op, args in code:
            if op.split(".")[0] != "BRA":
                continue
            target = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", args)
            if target is None:
                continue
            to = labels.get(target.group(1)) if target.group(1) \
                else int(target.group(2), 16)
            if to is not None and to <= addr:
                back.append((to, addr))
        for lo, hi in back:
            if any(lo <= a and b < hi for a, b in back if (a, b) != (lo, hi)):
                continue
            body_ops = [op for addr, op, _ in code if lo <= addr <= hi]
            bases = {op.split(".")[0] for op in body_ops}
            # a site loop reads and writes its memory and no other: no
            # tile loads from device memory, no index tables written
            if load not in bases or barred in bases:
                continue
            sites = sum(_store_bytes(op) for op in body_ops
                        if op.split(".")[0] == store)
            if not sites:
                continue
            pipes = collections.Counter(_pipe(op) for op in body_ops)
            ops = collections.Counter(body_ops)
            out.append({
                "kernel": name, "range": f"{lo:#x}-{hi:#x}",
                "instructions": len(body_ops), "sites": sites,
                "per_site": {p: v / sites for p, v in sorted(pipes.items())},
                "per_site_total": len(body_ops) / sites,
                "opcodes_per_site": {o: v / sites
                                     for o, v in ops.most_common()}})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("library", help="a library built from csrc/")
    parser.add_argument("--kernel", default="",
                        help="only kernels whose name holds this")
    parser.add_argument("--memory", choices=sorted(_LOOP_MEMORY),
                        default="shared",
                        help="the memory of the site loops (global: a "
                             "kernel that updates device memory)")
    args = parser.parse_args(argv)
    from repro_torch.kernels import _build
    sass = disassemble(args.library, _build.nvcc())
    for loop in site_loops(sass, args.kernel, args.memory):
        print(f"{Path(args.library).name} {loop['kernel']} loop "
              f"{loop['range']}: {loop['instructions']} instructions, "
              f"{loop['sites']} sites a pass; per site "
              f"{loop['per_site_total']:.2f}: " + ", ".join(
                  f"{p} {v:.2f}" for p, v in loop["per_site"].items())
              + "; opcodes per site " + ", ".join(
                  f"{o} {v:.2f}" for o, v in loop["opcodes_per_site"].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
