#!/usr/bin/env python3
"""Compare the fused BN + GELU kernels of two checkouts, and read their SASS.

Run from the root of a checkout; the kernels are that checkout's
``fastfourierconvolution_tpu_torch`` (built with its own ``_build``):

    python3 tools/bn_act_ab.py outputs OUT.json   # needs a CUDA card
    python3 tools/bn_act_ab.py compare A.json B.json
    python3 tools/bn_act_ab.py sass

``outputs``: seeded bf16 inputs (batch 64) at the 128px generator's five
packed maps, with and without the noise fold, through ``bn_gelu_apply``
and ``bn_bwd_reduce``; writes each apply output's sha256 and the reduce's
sums to OUT.json with the card's name and power limit. ``compare``: map by
map, whether the two apply outputs are equal bit for bit, and the largest
relative difference of the sums. ``sass``: for each kernel of the built
``bn_act`` library, ptxas's registers and spills, and from ``cuobjdump
-sass`` the innermost loop that evaluates tanh: its instructions, its tanh
evaluations (one per element: ``MUFU.EX2`` or ``MUFU.TANH``) and their
ratio, the instructions per element. A call in the loop counts its
callee's instructions.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

SEED = 0
PACKED_SHAPES = [(64, 512, 8, 8), (64, 256, 16, 16), (64, 128, 32, 32), (64, 128, 64, 64),
                 (64, 128, 128, 128)]


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def outputs(path: str) -> None:
    import torch

    from fastfourierconvolution_tpu_torch.ops import bn_act as ba

    if not torch.cuda.is_available():
        sys.exit("bn_act_ab: CUDA is not available")
    result = {"card": card_line(), "maps": {}}
    for shape in PACKED_SHAPES:
        b, c, h, w = shape
        gen = torch.Generator("cuda").manual_seed(SEED)
        randn = lambda *size: torch.randn(size, generator=gen, device="cuda")
        x = (randn(*shape) * 1.5 + 0.3).bfloat16()
        g = randn(*shape).bfloat16()
        n_l, n_g = randn(b, 1, h, w).bfloat16(), randn(b, 1, h, w).bfloat16()
        scale, bias, wn = randn(c).abs() + 0.5, randn(c) * 0.2, randn(c) * 0.3
        mean, var = (t.float() for t in ba.bn_stats_plain(x.double()))
        for noise in (False, True):
            extra = (n_l, n_g, c // 2) if noise else ()
            out = ba.bn_gelu_apply(x, mean, var, scale, bias, *((wn,) + extra if noise else ()))
            sums = ba.bn_bwd_reduce(x, g, mean, var, scale, bias, *extra)
            torch.cuda.synchronize()
            digest = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            result["maps"][f"{shape} noise={noise}"] = {
                "apply_sha256": digest, "reduce": [s.cpu().tolist() for s in sums]}
            print(f"{shape} noise={noise}: apply sha256 {digest[:16]}", flush=True)
    Path(path).write_text(json.dumps(result))


def compare(path_a: str, path_b: str) -> None:
    a, b = (json.loads(Path(p).read_text()) for p in (path_a, path_b))
    print(f"A: {path_a} ({a['card']}); B: {path_b} ({b['card']})")
    for key, ra in a["maps"].items():
        rb = b["maps"][key]
        worst = 0.0
        for sa, sb in zip(ra["reduce"], rb["reduce"]):
            top = max(abs(v) for v in sa)
            worst = max(worst, max(abs(u - v) for u, v in zip(sa, sb)) / top)
        print(f"{key}: apply bit-equal {ra['apply_sha256'] == rb['apply_sha256']}, "
              f"reduce sums rel-max {worst:.3e}")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def _kernel_name(mangled: str) -> str:
    """``name<dtype, flags...>`` of a mangled bn_act kernel symbol."""
    name = re.search(r"(bn_[a-z_]+_kernel)", mangled)
    dtype = "bf16" if "__nv_bfloat16" in mangled else "f32"
    flags = re.findall(r"Lb([01])E", mangled)
    return f"{name.group(1) if name else mangled}<{dtype}{''.join(', ' + f for f in flags)}>"


def _ptxas(log: str) -> dict:
    """{kernel: 'N registers, S bytes spill stores, L bytes spill loads'}."""
    found, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = _kernel_name(m.group(1))
            found[current] = {}
        elif current and "spill stores" in line:
            found[current]["spills"] = line.strip()
        elif current and re.search(r"Used \d+ registers", line):
            found[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return found


def _functions(sass: str) -> dict:
    """({kernel: [(address, instruction)]} of a cuobjdump listing,
    {(kernel, label): the address of the instruction after ``label:``})."""
    funcs, current, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = _kernel_name(m.group(1))
            funcs[current] = []
            continue
        if current is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[(current, label)] = addr
            pending = []
            funcs[current].append((addr, m.group(2)))
    return funcs, labels


def _target(fn, ins, labels):
    m = re.search(r"(0x[0-9a-f]+)\s*$", ins)
    if m:
        return int(m.group(1), 16)
    m = re.search(r"\((\.L_x_\d+)\)", ins)
    return labels.get((fn, m.group(1))) if m else None


def _count(fn, body, code, labels):
    """(instructions, tanh evaluations) of ``body``, each call's callee (up
    to its RET) counted once per call site."""
    n, tanh = len(body), 0
    for _, ins in body:
        tanh += bool(re.search(r"MUFU\.(EX2|TANH)", ins))
        if re.search(r"\bCALL\b", ins):
            start = _target(fn, ins, labels)
            callee = []
            for addr, c_ins in code:
                if start is not None and addr >= start:
                    callee.append((addr, c_ins))
                    if re.search(r"\bRET\b", c_ins):
                        break
            n += len(callee)
            tanh += sum(bool(re.search(r"MUFU\.(EX2|TANH)", i)) for _, i in callee)
    return n, tanh


def sass() -> None:
    from fastfourierconvolution_tpu_torch.ops import _build

    lib = _build.build_all()["bn_act"]
    log = Path(str(lib) + ".log")
    ptxas = _ptxas(log.read_text() if log.exists() else "")
    listing = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                             text=True, check=True).stdout
    funcs, labels = _functions(listing)
    for fn in sorted(set(funcs) | set(ptxas)):
        code = funcs.get(fn, [])
        best = None
        for addr, ins in code:
            if not re.search(r"\bBRA\b", ins):
                continue
            start = _target(fn, ins, labels)
            if start is None or start > addr:
                continue
            body = [(a, i) for a, i in code if start <= a <= addr]
            n, tanh = _count(fn, body, code, labels)
            if tanh and (best is None or n < best[0]):
                best = (n, tanh)
        info = ptxas.get(fn, {})
        loop = (f"inner loop {best[0]} instructions, {best[1]} tanh, "
                f"{best[0] / best[1]:.1f} per element" if best else "no loop with tanh")
        print(f"{fn}: {info.get('registers')} registers; {info.get('spills')}; {loop}; "
              f"{len(code)} instructions in all")


def main() -> None:
    mode, *args = sys.argv[1:] or ["sass"]
    {"outputs": outputs, "compare": compare, "sass": sass}[mode](*args)


if __name__ == "__main__":
    main()
