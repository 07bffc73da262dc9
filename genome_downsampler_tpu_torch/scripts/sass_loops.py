"""The loops of a compiled kernel, from its SASS.

    cuobjdump -sass lib.so > kernels.sass
    python -m genome_downsampler_tpu_torch.scripts.sass_loops kernels.sass REGEX

For each function of the dump whose mangled name matches ``REGEX``, prints
each loop (a branch back to a lower address: the instructions from its
target to the branch) with its count of instructions, of warp shuffles
(``SHFL``), shared loads and stores (``LDS``, ``STS``) and barriers
(``BAR``). A loop nested in another is printed on its own and inside the
outer one. The sweep loop of a sweep kernel is the one with its shuffles
and no barrier; its instruction count is the instructions a position.
Needs no card: it reads a dump made on one.
"""

from __future__ import annotations

import re
import sys

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA(?:\.\w+)* (?:`\(\.L_x_\d+\) )?0x([0-9a-f]+)")


def functions(text: str) -> dict:
    """``{mangled name: [(address, instruction), ...]}`` of a SASS dump."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTRUCTION.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def loops(instructions) -> list:
    """``[(first, last, counts)]`` of each backward branch, ``counts`` the
    loop's ``{"instructions", "SHFL", "LDS", "STS", "BAR"}``."""
    res = []
    for addr, text in instructions:
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) < addr:
            first = int(m.group(1), 16)
            body = [t for a, t in instructions if first <= a <= addr]
            counts = {"instructions": len(body)}
            for op in ("SHFL", "LDS", "STS", "BAR"):
                counts[op] = sum(re.search(rf"\b{op}\b", t) is not None for t in body)
            res.append((first, addr, counts))
    return res


def main(argv=None) -> None:
    path, pattern = (sys.argv[1:] if argv is None else argv)[:2]
    with open(path) as f:
        text = f.read()
    for name, ins in functions(text).items():
        if re.search(pattern, name):
            print(name)
            for first, last, c in loops(ins):
                print(f"  {first:#06x}-{last:#06x}: " + ", ".join(
                    f"{k} {v}" for k, v in c.items()))


if __name__ == "__main__":
    main()
