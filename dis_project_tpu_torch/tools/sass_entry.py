"""SASS instructions of one covariance entry of K1, K2 and K2's backward.

Usage, on a machine with ``nvcc`` and ``cuobjdump`` (no card needed)::

    python -m dis_project_tpu_torch.tools.sass_entry [--library FILE ...]

It compiles, with the package's own ``nvcc`` flags for ``sm_90a``, probe
kernels that include this package's ``csrc/simm_gram.cu`` and evaluate
ONE float32 entry of the hoisted form from kernel parameters
(``sym_value<XX>``, ``entry_value<XF>``, ``partials<XX>`` on the per-row
``RowQ``): ``fwd`` the 'xx' Gram value (K1 and K2), ``xf`` K1's 'xf'
value, ``bwd`` the five partials of K2's backward (before the float64
products with the cotangent), each with the per-entry erf (``fwd``, ``xf``,
``bwd``) and from the (gamma, time) tables (``fwd_table``, ``xf_table``,
``bwd_table``). A frame probe per pair stores parameters
only. One entry costs the probe's instructions minus its frame's
(``cuobjdump -sass``, NOPs left out). The inputs come from the constant
bank, so no load is counted; in the kernels they come from registers or
shared memory. The probes go to ``build/sass/``.

For each built library given (``build/kernels/libsimm_gram-*.so``, of
this design or an earlier one), it also prints every kernel's total
instruction count. One JSON line for the source and one per library.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import re
import subprocess
from pathlib import Path

from dis_project_tpu_torch.ops import cuda_build

_ROWQ = ("t", "tl", "D", "S", "f", "gam", "E", "e", "r", "C", "rD", "rl")
_PARTS = {"fwd": "sym_value<XX>(a, b, k, cross_terms<false, false, 3>(a, b, 0, 0, ct))",
          "fwd_table": "sym_value<XX>(a, b, k, c)",
          "xf": "entry_value<XF>(a, b, k, cross_terms<false, false, 1>(a, b, 0, 0, ct))",
          "xf_table": "entry_value<XF>(a, b, k, c)",
          "bwd": "partials<XX>(a, b, k, cross_terms<false, true, 3>(a, b, 0, 0, ct))",
          "bwd_table": "partials<XX>(a, b, k, c)"}
WORKDIR = cuda_build.BUILD_DIR.parent / "sass"
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _params(fields, prefix):
    return ", ".join(f"float {prefix}{f}" for f in fields)


def _probe_source(source: Path) -> str:
    """The probe kernels for ``source``."""
    args = (f"{_params(_ROWQ, 'a')}, {_params(_ROWQ, 'b')}, float l, float il, float cl, "
            "float two_l, float i2l, float f2, float f4, float p2, float p4, float* out")
    make = (f"  const RowQ<float> a{{{', '.join('a' + f for f in _ROWQ)}}};\n"
            f"  const RowQ<float> b{{{', '.join('b' + f for f in _ROWQ)}}};\n"
            "  const Scale<float> k{l, il, cl, two_l, i2l};\n"
            "  const Cross<float> c{f2, f4, p2, p4};\n"
            "  const CrossTables<float> ct{nullptr, nullptr};\n")
    out = [f'#include "{source.resolve()}"\n']
    for name, call in _PARTS.items():
        if not name.startswith("bwd"):
            body, frame = f"out[0] = {call};", "out[0] = at;"
        else:
            body = (f"const Partials<float> p = {call};\n"
                    "  out[0] = p.da; out[1] = p.sa; out[2] = p.db; out[3] = p.sb; out[4] = p.l;")
            frame = "out[0] = at; out[1] = bt; out[2] = l; out[3] = il; out[4] = cl;"
        out.append(f"__global__ void probe_{name}({args}) {{\n{make}  {body}\n}}\n"
                   f"__global__ void frame_{name}({args}) {{ {frame} }}\n")
    return "".join(out)


def _sass_counts(binary: Path) -> dict:
    """{function: Counter(opcode)} from ``cuobjdump -sass``, NOPs left out."""
    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(binary)], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = collections.Counter()
        elif name is not None:
            m = _INSN.search(line)
            if m and m.group(1) != "NOP":
                counts[name][m.group(1)] += 1
    return counts


def _named(counts, name):
    """The function ``name`` among mangled names (``_Z<len><name>...``)."""
    (key,) = [k for k in counts if f"{len(name)}{name}" in k]
    return counts[key]


def entry_counts(source: Path) -> dict:
    """Instructions of one entry of each probe in ``source``, with the
    multi-function-unit (MUFU) share."""
    WORKDIR.mkdir(parents=True, exist_ok=True)
    probe = WORKDIR / f"probe_{hashlib.sha1(str(source.resolve()).encode()).hexdigest()[:12]}.cu"
    probe.write_text(_probe_source(source))
    cubin = probe.with_suffix(".cubin")
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([cuda_build._nvcc(), *flags, "-cubin", "-o", str(cubin), str(probe)],
                   check=True, capture_output=True, text=True)
    counts = _sass_counts(cubin)
    out = {"source": str(source)}
    for part in _PARTS:
        body, frame = _named(counts, f"probe_{part}"), _named(counts, f"frame_{part}")
        mufu = sum(v for k, v in body.items() if k.startswith("MUFU"))
        out[part] = {"instructions": sum(body.values()) - sum(frame.values()),
                     "mufu": mufu, "probe": sum(body.values()), "frame": sum(frame.values())}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--library", action="append", type=Path, default=[],
                        help="a built libsimm_gram-*.so: every kernel's total")
    args = parser.parse_args(argv)
    print(json.dumps({"sass_per_entry": entry_counts(cuda_build.CSRC / "simm_gram.cu")}))
    for library in args.library:
        totals = {k: sum(v.values()) for k, v in _sass_counts(library).items()}
        print(json.dumps({"sass_kernel_totals": {"library": str(library), "kernels": totals}}))


if __name__ == "__main__":
    main()
