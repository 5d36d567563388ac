"""Which parts of the elementwise-block kernel's design pay, measured on the
card: the kernel as built against variations of it, in turns.

A variation is a set of textual substitutions in a copy of
`csrc/elementwise_block.cuh` (each must hit exactly as often as it says) and
of overrides of the wrapper's plan in `ops/hopper_kernels.py`; the sources in
the package are not touched and carry no switch. Every copy is compiled,
with the `.cu` files that hold the cases' entry points (one nvcc process
each, as the package builds them), with `-Xptxas -v`, so the run also
prints each instantiation's registers and spills.
Per variation and case the tool prints the device microseconds of one
launch, taken as built, varied, varied, as built (CUDA events around 40
launches of the C entry point on fixed buffers, which the host enqueues
faster than the card runs them; median of 5), after holding the outputs
against the plain version (a variation that cuts the sums out skips those).

It also times the wrapper on the host: the enqueue time of one call (host
clock around a batch, no synchronize inside), and four `torch.empty_like`
against one `(4, ...)` buffer with `unbind`.

`--sass` reads every build with `cuobjdump -sass` and prints, for each of
SASS_VARIANTS, the vector loop's instructions per element by kind: on its
hot path (what a group of in-range data issues) and in the whole loop
(rarely run code included), beside the issue budget the byte bound leaves
at the SM clock nvidia-smi reads under load. `--against FILE` runs another
revision of the header, built with the .cu files beside it, as one more
variation; with it, `--bitwise` compares every store of each variant both
builds hold bit for bit on phase 2's kinds of inputs, `--solves` the final
state of the main path's solves and of one solve per such variant, and
`--every` times each such variant of both builds in turns (four readings a
side) and prints each side's spread, and times the variants only this
build holds four times alone (without `--against`, every variant).
`--pointer` times every variant's pointer entry (the penalties read from
device memory, as the solve's CUDA graph launches it) against its by-value
entry at taxi, in turns, four readings a side, after holding the two
entries' stores bitwise equal, and prints the registers and spills of both
instantiations of every variant; with `--pointer-variations` also each of
POINTER_VARIATIONS, other designs of the pointer instantiation. With
`--against` and `--every`, `--pointer` also times every variant's pointer
entry of both builds in turns, and `--bitwise` compares both entries.
`--batch` times every variant's batched entry (`elementwise_block_batch`:
BATCH_ENTRIES entries of taxi in one launch) against as many launches of
its pointer entry, one an entry, in turns, four readings a side, after
holding each entry's stores and sums bitwise the pointer entry's launch on
that entry alone. `quotient_divisors` and
`quotient_check` hold the kernel's division to '/' on the card
(`chip_smoke.py` phase 2).

Needs a CUDA device and nvcc. Usage:
    python -m tritd_tpu_torch.tools.sweep_block [--launches 40] [--only NAME ...] [--sass [--sass-out DIR]]
        [--against OTHER/csrc/elementwise_block.cuh [--bitwise] [--solves] [--every]]
        [--pointer [--pointer-variations]] [--batch]
        [--out result.json]
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..cli.run_completion import resolve_device
from ..ops import hopper_kernels
from ..ops.narrow import narrow_cast
from ..runtime import build, kernels
from .profile_device import MU_NEXT, PEAK_BYTES_PER_S, SCALARS, SHAPES, SLAB_SHAPES, block_bytes_per_element

SOURCE = build.SRC_DIR / "elementwise_block.cuh"
ENTRY = re.compile(r"^TRITD_BLOCK_ENTRY\(tritd_elementwise_block_(\w+),", re.M)
# (variant, shape name): the main path's float32 shapes, the smallest slab a
# rank holds, one variant each with bf16 storage and double compute, and one
# each with float16 and float8 storage (8 bytes of float8 an access beside
# float, 4 beside double)
CASES = (("f32", "taxi"), ("f32", "video"), ("f32", "slab4"), ("f32", "slab3"),
         ("c32_dbf16_sbf16_tbf16", "taxi"), ("c32_d32_sbf16_tbf16", "slab2"), ("f64", "taxi"),
         ("c64_d64_s64_tbf16", "taxi"), ("c32_df16_sf16_tf16", "taxi"), ("c32_de4m3_se4m3_te4m3", "taxi"),
         ("c32_de5m2_se5m2_te5m2", "taxi"), ("c32_de5m2_se5m2_te5m2", "video"), ("c64_de5m2_se5m2_te5m2", "taxi"))
# the variants whose vector loop `--sass` counts
# entries of `--batch`'s launches: the batch of four of the reference's
# batched rows (BASELINE.json configuration 5, bench.py's batched completion)
BATCH_ENTRIES = 4
SASS_VARIANTS = ("c32_de5m2_se5m2_te5m2", "c64_de5m2_se5m2_te5m2", "c32_de4m3_se4m3_te4m3", "c32_df16_sf16_tf16",
                 "f32")


def _geometry(threads: int, per_sm: int) -> dict:
    resident = 132 * per_sm
    return {"BLOCK_THREADS": threads, "RESIDENT_BLOCKS": resident, "SCRATCH_LEN": 2 * resident + 1}


def _old_grid(n: int, group: int) -> int:
    return min(max(1, -(-(-(-n // group)) // 256)), 2048)


def _groups(group_size) -> dict:
    """Plan overrides for another `group_size(widest bytes, narrowest bytes)`."""
    return {"group_size": group_size,
            "VARIANT_GROUP": {v: group_size(max(dt.itemsize for dt in key), min(dt.itemsize for dt in key))
                              for key, v in hopper_kernels.KERNEL_VARIANTS.items()}}


# name -> (source substitutions [(old, new, count)], overrides of hopper_kernels, sums valid)
VARIATIONS = {
    "one element a turn (no 16-byte access)": ([], {"pointers_aligned": lambda *p: False}, True),
    "grid of up to 2048 blocks, ragged turns": (
        [("kMaxBlocks = kSMs * kBlocksPerSM;", "kMaxBlocks = 2048;", 1),
         ("__launch_bounds__(kThreads, kBlocksPerSM)", "__launch_bounds__(kThreads)", 1)],
        {"RESIDENT_BLOCKS": 2048, "SCRATCH_LEN": 4097, "block_grid": _old_grid}, True),
    "grid of up to 2048 blocks, ragged turns, 2 blocks an SM kept": (
        [("kMaxBlocks = kSMs * kBlocksPerSM;", "kMaxBlocks = 2048;", 1)],
        {"RESIDENT_BLOCKS": 2048, "SCRATCH_LEN": 4097, "block_grid": _old_grid}, True),
    "whole turns in up to 1056 blocks (4 waves)": (
        [("kMaxBlocks = kSMs * kBlocksPerSM;", "kMaxBlocks = 1056;", 1)],
        {"RESIDENT_BLOCKS": 1056, "SCRATCH_LEN": 2113}, True),
    "whole turns in up to 2112 blocks (8 waves)": (
        [("kMaxBlocks = kSMs * kBlocksPerSM;", "kMaxBlocks = 2112;", 1)],
        {"RESIDENT_BLOCKS": 2112, "SCRATCH_LEN": 4225}, True),
    "no sum across blocks (the cost of the last block's pass)": (
        [("if (!is_last) return;", "return;", 1)], {}, False),
    "1 resident block an SM": ([("kBlocksPerSM = 2;", "kBlocksPerSM = 1;", 1)], _geometry(256, 1), True),
    "3 resident blocks an SM": ([("kBlocksPerSM = 2;", "kBlocksPerSM = 3;", 1)], _geometry(256, 3), True),
    "4 resident blocks an SM (64 registers)": (
        [("kBlocksPerSM = 2;", "kBlocksPerSM = 4;", 1)], _geometry(256, 4), True),
    "128 threads a block, 4 an SM": (
        [("kThreads = 256;", "kThreads = 128;", 1), ("kBlocksPerSM = 2;", "kBlocksPerSM = 4;", 1)],
        _geometry(128, 4), True),
    "512 threads a block, 1 an SM": (
        [("kThreads = 256;", "kThreads = 512;", 1), ("kBlocksPerSM = 2;", "kBlocksPerSM = 1;", 1)],
        _geometry(512, 1), True),
    "cached loads (ld.global.nc) in place of streaming ones": (
        [("__ldcs(reinterpret_cast", "__ldg(reinterpret_cast", 3)], {}, True),
    "streaming stores (st.global.cs)": ([("{ *p = v; }", "{ __stcs(p, v); }", 3)], {}, True),
    "32 bytes of the narrowest stream a turn": (
        [("kByStream = 16 / kNarrowest;", "kByStream = 32 / kNarrowest;", 1)],
        _groups(lambda c, n: min(32 // n, 32 // c)), True),
    # the design of the float8 paths, one part at a time put back as the
    # parent had it (same results)
    "divisions with '/' per element": ([("  if constexpr (kExact) {\n    return x / q.y;",
                                         "  if constexpr (true) {\n    return x / q.y;", 1)], {}, True),
    "float8 store fix-up on every group": ([("    if (past) {\n", "    if (true) {\n", 1)], {}, True),
    "T' from a second rounding of O' and Y_L'": (
        [("      unpack(wo_new, o_st);\n      unpack(wyl_new, yl_st);\n",
          "#pragma unroll\n      for (int j = 0; j < G; ++j) {\n        o_st[j] = cvt<C>(cvt<S>(o_new[j]));\n"
          "        yl_st[j] = cvt<C>(cvt<S>(yl_new[j]));\n      }\n", 1)], {}, True),
    "float8 groups of 16 beside float, 8 beside double": (
        [("static constexpr int kCap = 32 / kWidest;",
          "static constexpr int kCap = (kNarrowest == 1 ? 64 : 32) / kWidest;", 1)],
        _groups(lambda c, n: min(16 // n, (64 if n == 1 else 32) // c)), True),
}

# other designs of the pointer instantiation (`--pointer-variations`), timed
# like the header as built: name -> source substitutions
_PREFETCH = """    if (first < n_vec) {
      prefetch_l2(d + first);
      prefetch_l2(l + first);
      prefetch_l2(e + first);
      prefetch_l2(y_l + first);
      prefetch_l2(y_o + first);
    }
"""
_STAGED = """    if (threadIdx.x == 0) {
      staged[0] = *mu_l_at;
      staged[1] = *mu_o_at;
      staged[2] = *mu_l_next_at;
    }
    __syncthreads();
    mu_l = staged[0];
    mu_o = staged[1];
    mu_l_next = staged[2];
"""
POINTER_VARIATIONS = {
    "pointer entry without the L2 prefetch of the first group": [(_PREFETCH, "", 1)],
    "pointer entry, each thread loading the penalties (__ldg), no staging": [
        (_STAGED, "    mu_l = __ldg(mu_l_at);\n    mu_o = __ldg(mu_o_at);\n    mu_l_next = __ldg(mu_l_next_at);\n", 1)],
}

# SASS base opcodes (before the first '.') by what they are counted as
SASS_KINDS = {
    "fp32": {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FADD32I", "FMUL32I", "FFMA32I",
             "FSWZADD", "HADD2", "HFMA2", "HMUL2", "HSETP2", "HMNMX2"},
    "fp64": {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX"},
    "convert": {"F2F", "F2FP", "F2I", "I2F", "I2FP", "F2IP", "FRND"},
    "integer": {"IADD3", "IMAD", "IMUL", "LOP3", "SHF", "SEL", "ISETP", "LEA", "PRMT", "IABS", "IMNMX", "VIMNMX",
                "FLO", "POPC", "BMSK", "SGXT", "MOV", "PLOP3", "P2R", "R2P", "IADD"},
    "mufu": {"MUFU"},
    "branch": {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "BREAK", "WARPSYNC"},
    "memory": {"LDG", "STG", "LD", "ST", "LDS", "STS", "LDC", "ATOM", "ATOMG", "RED"},
}
_SASS_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")
# the C++ type of each dtype in the kernel's template arguments
_CXX_TYPE = {torch.float32: "float", torch.float64: "double", torch.bfloat16: "__nv_bfloat16",
             torch.float16: "__half", torch.float8_e4m3fn: "e4m3", torch.float8_e5m2: "e5m2"}


def parse_sass(text: str) -> dict[str, list[dict]]:
    """`cuobjdump -sass` output -> function name -> its instructions, each
    {"addr", "pred" (the guard, e.g. "@!P0", or ""), "op" (opcode with
    modifiers), "args", "target" (a branch's address, or None)}. Branch
    targets may be labels (`(.L_x_N)) or addresses."""
    functions: dict[str, list[dict]] = {}
    labels: dict[str, dict[str, int]] = {}
    insns, name, pending = None, None, []
    for line in text.splitlines():
        m = _SASS_FUNCTION.match(line)
        if m:
            name = m.group(1)
            insns, labels[name], pending = functions.setdefault(name, []), {}, []
            continue
        if insns is None:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSN.match(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for label in pending:
            labels[name][label] = addr
        pending = []
        guard = re.match(r"^(@!?U?P\w+)\s+", m.group(2))
        op, _, args = m.group(2)[guard.end() if guard else 0:].partition(" ")
        insns.append({"addr": addr, "pred": guard.group(1) if guard else "", "op": op, "args": args.strip(),
                      "target": None})
    for name, body in functions.items():
        for insn in body:
            if insn["op"].split(".")[0] in ("BRA", "BRX", "JMP"):
                t = _SASS_TARGET.search(insn["args"])
                if t:
                    insn["target"] = labels[name].get(t.group(1)) if t.group(1) else int(t.group(2), 16)
    return functions


def vector_loop(insns: list[dict]) -> list[dict]:
    """The instructions of the kernel's vector loop: the innermost range
    between a backward branch and its target that holds a 16-byte global
    load (L's, which the one-element loop never has)."""
    best = None
    for insn in insns:
        t = insn["target"]
        if t is None or t > insn["addr"]:
            continue
        body = [x for x in insns if t <= x["addr"] <= insn["addr"]]
        if any(x["op"].startswith("LDG") and ".128" in x["op"] for x in body):
            if best is None or len(body) < len(best):
                best = body
    if best is None:
        raise ValueError("no backward branch encloses a 16-byte global load")
    return best


def hot_path(loop: list[dict]) -> list[dict]:
    """The instructions on the shortest way through the loop body, from its
    first instruction to its backward branch: a guarded branch may go either
    way, an unguarded one jumps, a call returns. Code a group seldom runs
    (a division's slow-path call, a group redone with '/', JAX's float8 NaN
    and infinities put back) lies on the longer ways, so this is what a
    group of in-range data issues."""
    index = {x["addr"]: k for k, x in enumerate(loop)}
    last = len(loop) - 1
    prev: dict[int, int | None] = {0: None}
    frontier = [0]
    while last not in prev and frontier:  # breadth first: every instruction weighs one
        step = []
        for k in frontier:
            insn = loop[k]
            base = insn["op"].split(".")[0]
            if base in ("EXIT", "RET"):
                nxt = []
            elif base in ("BRA", "JMP") and insn["target"] is not None:
                jump = [index[insn["target"]]] if insn["target"] in index else []
                nxt = ([k + 1] if insn["pred"] not in ("", "@PT") else []) + jump
            else:
                nxt = [k + 1]
            for j in nxt:
                if j <= last and j not in prev:
                    prev[j] = k
                    step.append(j)
        frontier = step
    if last not in prev:
        raise ValueError("the loop's backward branch cannot be reached from its first instruction")
    path, k = [], last
    while k is not None:
        path.append(loop[k])
        k = prev[k]
    return path[::-1]


def count_kinds(insns: list[dict]) -> dict[str, int]:
    """Instructions by SASS_KINDS, "other" for the rest, and "total"."""
    counts = dict.fromkeys((*SASS_KINDS, "other"), 0)
    for insn in insns:
        base = insn["op"].split(".")[0]
        counts[next((k for k, ops in SASS_KINDS.items() if base in ops), "other")] += 1
    counts["total"] = len(insns)
    return counts


def kernel_types(variant: str) -> str:
    """The template arguments of a variant's kernel, as c++filt prints them."""
    (key,) = (k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    return ", ".join(_CXX_TYPE[dt] for dt in key)


def issue_budget(bytes_per_element: int, sm_mhz: float) -> float:
    """Warp-lane instructions the card issues per element while it moves
    `bytes_per_element` at PEAK_BYTES_PER_S: 132 SMs x 128 lanes a clock.
    The FP64 pipe gets half of it; MUFU and the conversions (16 a clock an
    SM) an eighth."""
    return 132 * 128 * sm_mhz * 1e6 / (PEAK_BYTES_PER_S / bytes_per_element)


def _tool(name: str) -> str:
    """A CUDA toolkit program: on PATH, else beside nvcc."""
    return shutil.which(name) or str(Path(build.find_nvcc()).parent / name)


def cuobjdump_sass(library: Path) -> str:
    return subprocess.run([_tool("cuobjdump"), "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def sass_loops(text: str, variants, groups: dict) -> dict[str, dict]:
    """variant -> {"static" (instructions of the vector loop), "hot" (those
    of its hot_path), "per_element" (the hot counts over the variant's
    group), "function" (the kernel's whole listing)} from the
    `cuobjdump -sass` text of a built library."""
    functions = parse_sass(text)
    mangled = [n for n in functions if "elementwise_block_kernel" in n]
    names = dict(zip(_demangle(mangled), mangled))
    out = {}
    for variant in variants:
        # the by-value instantiation (a header before the pointer entries has no flag)
        want = f"elementwise_block_kernel<{kernel_types(variant)}"
        found = [m for d, m in names.items() if f"{want}>" in d or f"{want}, false>" in d]
        if len(found) != 1:
            raise RuntimeError(f"{variant}: {len(found)} kernels named {want} in the SASS")
        loop = vector_loop(functions[found[0]])
        hot = count_kinds(hot_path(loop))
        out[variant] = {"static": count_kinds(loop), "hot": hot,
                        "per_element": {k: v / groups[variant] for k, v in hot.items()},
                        "function": "\n".join(f"/*{x['addr']:04x}*/ {x['pred']} {x['op']} {x['args']}"
                                              for x in functions[found[0]])}
    return out


def sm_clock_during(fn) -> tuple[float, float]:
    """(SM clock, its maximum) in MHz, as nvidia-smi reads them while `fn`
    runs again and again."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                            stdout=subprocess.PIPE, text=True)
    while proc.poll() is None:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    now, top = (float(x) for x in proc.stdout.read().strip().splitlines()[0].split(","))
    return now, top


def _unit_files(variants, src_dir: Path = build.SRC_DIR) -> list[Path]:
    """The .cu files of `src_dir` that hold an entry point of `variants`,
    and elementwise_block.cu (the geometry the wrapper checks)."""
    return [src for src in sorted(src_dir.glob("*.cu"))
            if src.name == "elementwise_block.cu" or set(ENTRY.findall(src.read_text())) & set(variants)]


def _demangle(names: list[str]) -> list[str]:
    """C++ names through c++filt (or the toolkit's cu++filt) where one is
    installed, else as they are."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        cuda = Path(build.find_nvcc()).parent / "cu++filt"
        tool = str(cuda) if cuda.exists() else None
    if tool is None:
        return names
    return subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()


def compile_source(text: str, out_dir: Path, tag: str, variants,
                   src_dir: Path = build.SRC_DIR) -> tuple[Path, list[dict], list[str]]:
    """Compile `text` as the kernel's header with the .cu files of `src_dir`
    that hold `variants`, with the package's flags plus -Xptxas -v; returns
    the library, one {kernel, registers, spill_bytes} per instantiation, and
    the variants the library holds."""
    unit_dir = out_dir / tag
    unit_dir.mkdir()
    (unit_dir / SOURCE.name).write_text(text)
    units = [Path(shutil.copy(src, unit_dir)) for src in _unit_files(variants, src_dir)]
    out = out_dir / f"{tag}.so"
    logs = build.compile_library(units, out, extra_flags=("-Xptxas", "-v"), work_dir=out_dir)
    rows, mangled, name = [], [], None
    for line in "\n".join(logs).splitlines():
        m = re.search(r"Compiling entry function '(\w*elementwise_block_kernel\w*)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            mangled.append(name)
            rows.append({"registers": int(m.group(1)), "spill_bytes": spill})
            name = None
    for row, kernel in zip(rows, _demangle(mangled)):
        types = re.search(r"elementwise_block_kernel<([^>]*)>", kernel)
        row["kernel_types_c_d_s_t"] = types.group(1) if types else kernel
    held = sorted({v for src in units for v in ENTRY.findall(src.read_text())})
    return out, rows, held


class Built:
    """A compiled copy of the kernel with the plan overrides that go with it:
    the .cu files that hold `variants` (default: those of CASES)."""

    def __init__(self, name, text, overrides, out_dir, variants=None, src_dir: Path = build.SRC_DIR):
        self.name, self.overrides = name, overrides
        variants = {variant for variant, _shape in CASES} if variants is None else set(variants)
        self.path, self.registers, held = compile_source(text, out_dir, re.sub(r"\W+", "_", name), variants,
                                                         src_dir)
        self.lib = kernels.bind(self.path, variants=held)
        self.groups = {v: getattr(self.lib, f"tritd_elementwise_block_{v}_group")() for v in held}

    def __enter__(self):
        self.saved = {k: getattr(hopper_kernels, k) for k in self.overrides}
        self.saved_library = kernels.library
        for k, v in self.overrides.items():
            setattr(hopper_kernels, k, v)
        kernels.library = lambda: self.lib
        self._fresh()

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(hopper_kernels, k, v)
        kernels.library = self.saved_library
        self._fresh()

    @staticmethod
    def _fresh():
        hopper_kernels._entry.cache_clear()
        hopper_kernels._pointer_entry.cache_clear()
        hopper_kernels._batch_entry.cache_clear()
        hopper_kernels._SCRATCH.clear()


def vary(text: str, subs) -> str:
    for old, new, count in subs:
        if text.count(old) != count:
            raise RuntimeError(f"{old!r} occurs {text.count(old)} times in {SOURCE.name}, not {count}")
        text = text.replace(old, new)
    return text


def make_case(variant: str, shape_name: str, batch: int | None = None):
    """(inputs, keywords, plain outputs) of a variant at a shape; with
    `batch`, that many entries of it stacked on a first axis."""
    (cd, d_dt, s_dt, t_dt), = (k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    if d_dt == cd and s_dt != cd:
        t_dt = None  # masked narrow storage carries no T'
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = SHAPES.get(shape_name) or SLAB_SHAPES[shape_name]
    if batch is not None:
        shape = (batch, *shape)
    raw = [torch.randn(shape, generator=gen, device="cuda") * 3 for _ in range(5)]
    args = [narrow_cast(raw[0], d_dt), raw[1].to(cd), *(narrow_cast(x, s_dt) for x in raw[2:])]
    kw = dict(mu_l_next=None if t_dt is None else MU_NEXT, t_dtype=t_dt)
    plain = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=kw["mu_l_next"], compute_dtype=cd,
                                        store_dtype=s_dt, t_dtype=t_dt)
    return args, kw, plain


def launch_again(args, kw, pointer: bool = False):
    """One wrapper call; returns a function that repeats its launch of the C
    entry point with the same arguments, and the call's outputs (which keep
    the buffers alive). `pointer`: the call passes the penalties as 0-d
    tensors, views of a buffer kept alive here, so it takes the pointer
    entry."""
    name = "_pointer_entry" if pointer else "_entry"
    real, seen = getattr(hopper_kernels, name), {}
    mus = torch.tensor([SCALARS[0], SCALARS[1], kw["mu_l_next"] or SCALARS[0]], dtype=args[1].dtype, device="cuda")

    def spy(variant):
        found = real(variant)
        fn = found if pointer else found[0]

        def record(*argv):
            seen["again"] = lambda keep=mus: fn(*argv)  # keeps the penalties' buffer alive
            return fn(*argv)
        return record if pointer else (record, *found[1:])

    setattr(hopper_kernels, name, spy)
    try:
        penalties = (mus[0], mus[1], SCALARS[2]) if pointer else SCALARS
        call_kw = dict(kw, mu_l_next=mus[2]) if pointer and kw["mu_l_next"] is not None else kw
        got = hopper_kernels._block_cuda(*args, *penalties, **call_kw)
    finally:
        setattr(hopper_kernels, name, real)
    return seen["again"], got


def batch_again(args, kw):
    """One call of the batched entry on the stacked `args`, the penalties
    SCALARS for every entry; returns a function that repeats its launch of
    the C entry point with the same arguments, and the call's outputs."""
    real, seen = hopper_kernels._batch_entry, {}
    nb = args[0].shape[0]
    mus = torch.tensor([SCALARS[0], SCALARS[1], kw["mu_l_next"] or SCALARS[0]], dtype=args[1].dtype,
                       device="cuda").repeat_interleave(nb).view(3, nb)

    def spy(variant):
        fn = real(variant)

        def record(*argv):
            seen["again"] = lambda keep=mus: fn(*argv)  # keeps the penalties' buffer alive
            return fn(*argv)
        return record

    hopper_kernels._batch_entry = spy
    try:
        got = hopper_kernels.elementwise_block_batch(*args, mus[0], mus[1], SCALARS[2],
                                                     mu_l_next=None if kw["mu_l_next"] is None else mus[2],
                                                     t_dtype=kw["t_dtype"])
    finally:
        hopper_kernels._batch_entry = real
    return seen["again"], got


def device_us(fn, launches: int) -> float:
    """Device microseconds per call of `fn`: CUDA events around `launches`
    calls, the median of 5 such batches."""
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches * 1e3)
    return sorted(times)[2]


def batch_turns(built: Built, launches: int) -> list[dict]:
    """Every variant of `built` at BATCH_ENTRIES x taxi: one launch of its
    batched entry against BATCH_ENTRIES launches of its pointer entry, one
    on each entry; first each entry's stores and both sums held bitwise
    (raises if any differs), then in turns batch, pointer, pointer, batch
    twice (four readings a side), each side's spread and the change."""
    names = ("o", "e", "y_l", "y_o", "nl", "no", "t")
    rows = []
    for variant in sorted(built.groups):
        args, kw, _plain = make_case(variant, "taxi", batch=BATCH_ENTRIES)
        with built:
            again, got = batch_again(args, kw)
            singles = [launch_again([a[i] for a in args], kw, pointer=True) for i in range(BATCH_ENTRIES)]
            torch.cuda.synchronize()
            wrong = [(i, names[j]) for i, (_again, one) in enumerate(singles) for j in range(7)
                     if one[j] is not None and not same_bits(got[j][i], one[j])]
            if wrong:
                raise AssertionError(f"{variant}: the batched entry's (entry, output) {wrong} differ from the "
                                     f"pointer entry's launch on that entry alone")
            sides = {"batch": again, "pointer": lambda: [one_again() for one_again, _out in singles]}
            us = {"batch": [], "pointer": []}
            for side in ("batch", "pointer", "pointer", "batch") * 2:
                us[side].append(device_us(sides[side], launches))
        batch, pointer = us["batch"], us["pointer"]
        row = {"variant": variant, "shape": f"{BATCH_ENTRIES}x taxi",
               "bound_us": _case_bytes(variant, "taxi") * args[0].numel() / PEAK_BYTES_PER_S * 1e6,
               "batch_us": batch, "pointer_us": pointer,
               "batch_spread": (max(batch) - min(batch)) / np.median(batch),
               "pointer_spread": (max(pointer) - min(pointer)) / np.median(pointer),
               "change": float(np.median(batch) / np.median(pointer) - 1)}
        rows.append(row)
        print(f"batch {variant:24s} {BATCH_ENTRIES}x taxi bound {row['bound_us']:6.1f} us: batched "
              + " ".join(f"{x:7.2f}" for x in batch) + f" (spread {row['batch_spread']:.1%}); {BATCH_ENTRIES} "
              f"pointer launches " + " ".join(f"{x:7.2f}" for x in pointer)
              + f" (spread {row['pointer_spread']:.1%}); median {row['change']:+.1%}; share of the bound "
              f"{row['bound_us'] / np.median(batch):.0%}; stores and sums bitwise", flush=True)
        del args, got, singles
    return rows


def measure(built: Built, args, kw, plain, launches: int, sums_valid: bool,
            pointer: bool = False) -> tuple[float, float]:
    """(device us per launch, largest |kernel - plain| over the outputs);
    `pointer`: through the variant's pointer entry."""
    with built:
        again, got = launch_again(args, kw, pointer)
        torch.cuda.synchronize()
        idx = [i for i in (0, 1, 2, 3, 6) if got[i] is not None]
        worst = max(float((got[i].double() - plain[i].double()).abs().nan_to_num().max()) for i in idx)
        if sums_valid:
            for i in (4, 5):
                torch.testing.assert_close(got[i], plain[i], rtol=1e-5, atol=0.0)
        us = device_us(again, launches)
    return us, worst


def every_case(variants=None) -> list[tuple[str, str]]:
    """The cases of `--every`: each of `variants` (default: every variant)
    at taxi, and each that computes in float32 at video too."""
    variants = sorted(hopper_kernels.KERNEL_VARIANTS.values() if variants is None else variants)
    return [(v, "taxi") for v in variants] + [(v, "video") for v in variants if _key(v)[0] == torch.float32]


def time_in_turns(mine: Built, theirs: Built | None, launches: int, pointer: bool = False) -> list[dict]:
    """Device us per launch of every case of `every_case` of `mine`'s
    variants. One that `theirs` holds too is taken with both builds, mine,
    theirs, theirs, mine, mine, theirs, theirs, mine (four readings a side,
    each the median of 5 batches as `measure` takes them), and printed with
    its readings, their spread ((max - min) / median) and the change of
    mine's median against theirs; the others (all, with no `theirs`) four
    readings of mine alone, beside the byte bound. `pointer`: through the
    pointer entry."""
    rows = []
    entry = "pointer " if pointer else ""
    for variant, shape in every_case(mine.groups):
        args, kw, plain = make_case(variant, shape)
        alone = theirs is None or variant not in theirs.groups
        us = {mine.name: []} if alone else {mine.name: [], theirs.name: []}
        worst = 0.0
        for built in (mine,) * 4 if alone else (mine, theirs, theirs, mine) * 2:
            t, err = measure(built, args, kw, plain, launches, True, pointer)
            us[built.name].append(t)
            worst = max(worst, err)
        new = us[mine.name]
        if alone:
            row = {"variant": variant, "shape": shape, "bound_us": _case_bytes(variant, shape) * args[0].numel()
                   / PEAK_BYTES_PER_S * 1e6, "us": new, "max_abs_err": worst,
                   "spread": (max(new) - min(new)) / np.median(new)}
            rows.append(row)
            print(f"alone {variant:24s} {shape:6s} {_case_bytes(variant, shape):2d} B/elem, bound "
                  f"{row['bound_us']:6.1f} us: " + " ".join(f"{x:7.2f}" for x in new)
                  + f" (spread {row['spread']:.1%}); share of the bound {row['bound_us'] / np.median(new):.0%}",
                  flush=True)
            del args, plain
            continue
        old = us[theirs.name]
        row = {"variant": variant, "shape": shape, "entry": "pointer" if pointer else "by value",
               "bound_us": _case_bytes(variant, shape) * args[0].numel()
               / PEAK_BYTES_PER_S * 1e6, "us": new, "against_us": old, "max_abs_err": worst,
               "spread": (max(new) - min(new)) / np.median(new),
               "against_spread": (max(old) - min(old)) / np.median(old),
               "change": float(np.median(new) / np.median(old) - 1)}
        rows.append(row)
        print(f"turns {entry}{variant:24s} {shape:6s} bound {row['bound_us']:6.1f} us: as built "
              + " ".join(f"{x:7.2f}" for x in new) + f" (spread {row['spread']:.1%}); against "
              + " ".join(f"{x:7.2f}" for x in old) + f" (spread {row['against_spread']:.1%}); "
              f"median {row['change']:+.1%}", flush=True)
        del args, plain
    return rows


def pointer_turns(built: Built, launches: int) -> list[dict]:
    """Every variant of `built` at taxi through its pointer entry and its
    by-value entry: first both once, every store and both sums compared bit
    for bit (raises if any differs), then in turns by-value, pointer,
    pointer, by-value twice (four readings a side, each the median of 5
    batches), with each side's spread and the pointer entry's change."""
    rows = []
    for variant in sorted(built.groups):
        args, kw, plain = make_case(variant, "taxi")
        with built:
            outs = [launch_again(args, kw, pointer)[1] for pointer in (False, True)]
        torch.cuda.synchronize()
        wrong = [i for i in (0, 1, 2, 3, 4, 5, 6) if outs[0][i] is not None and not same_bits(outs[0][i], outs[1][i])]
        if wrong:
            raise AssertionError(f"{variant}: the pointer entry's outputs {wrong} differ from the by-value entry's")
        us = {False: [], True: []}
        for pointer in (False, True, True, False) * 2:
            us[pointer].append(measure(built, args, kw, plain, launches, True, pointer)[0])
        by_value, by_pointer = us[False], us[True]
        row = {"variant": variant, "shape": "taxi", "bound_us": _case_bytes(variant, "taxi") * args[0].numel()
               / PEAK_BYTES_PER_S * 1e6, "by_value_us": by_value, "pointer_us": by_pointer,
               "by_value_spread": (max(by_value) - min(by_value)) / np.median(by_value),
               "pointer_spread": (max(by_pointer) - min(by_pointer)) / np.median(by_pointer),
               "change": float(np.median(by_pointer) / np.median(by_value) - 1)}
        rows.append(row)
        print(f"pointer {variant:24s} taxi bound {row['bound_us']:6.1f} us: by value "
              + " ".join(f"{x:7.2f}" for x in by_value) + f" (spread {row['by_value_spread']:.1%}); pointer "
              + " ".join(f"{x:7.2f}" for x in by_pointer) + f" (spread {row['pointer_spread']:.1%}); median "
              f"{row['change']:+.1%}; stores bitwise equal", flush=True)
        del args, plain, outs
    return rows


def print_pointer_summary(name: str, rows: list[dict]) -> None:
    slow = max(rows, key=lambda r: r["change"])
    spread = max(max(r["by_value_spread"], r["pointer_spread"]) for r in rows)
    beyond = [r["variant"] for r in rows if abs(r["change"]) > max(r["by_value_spread"], r["pointer_spread"])]
    print(f"{name}: {len(rows)} variants, stores bitwise the by-value entry's; median change "
          f"{np.median([r['change'] for r in rows]):+.2%}, largest {slow['variant']} {slow['change']:+.1%}; "
          f"largest spread {spread:.1%}; {len(beyond)} beyond both sides' spread: {', '.join(beyond)}", flush=True)


def host_times(reps: int = 200) -> dict:
    """Host microseconds: one wrapper call's enqueue at the quarter slab
    (where the card is never the one waited for), and the two ways to
    allocate the four stored outputs."""
    args, kw, _ = make_case("f32", "slab4")
    e = args[2]

    def clock(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    return {
        "wrapper_enqueue_us": clock(lambda: hopper_kernels._block_cuda(*args, *SCALARS, **kw)),
        "four_empty_like_us": clock(lambda: [torch.empty_like(e) for _ in range(4)]),
        "one_buffer_unbind_us": clock(lambda: torch.empty((4, *e.shape), dtype=e.dtype, device=e.device).unbind(0)),
    }


def _case_bytes(variant: str, shape_name: str) -> int:
    (cd, d_dt, s_dt, t_dt), = (k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    return block_bytes_per_element(d_dt, cd, s_dt, None if d_dt == cd and s_dt != cd else t_dt)


def _key(variant: str) -> tuple:
    (key,) = (k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    return key


def variant_inputs(variant: str) -> list[tuple[list, dict, tuple]]:
    """Phase 2's kinds of inputs of a variant, as (args, kw, scalars): randn
    x 3 at the taxi shape narrowed to its dtypes, the edge values of the
    narrow formats, and for a float8 variant all 256 codes of each float8
    dtype it holds."""
    key = _key(variant)
    cd, d_dt, s_dt, t_dt = key
    masked = d_dt == cd and s_dt != cd
    out = []
    gen = torch.Generator(device="cuda").manual_seed(sorted(hopper_kernels.KERNEL_VARIANTS.values()).index(variant))
    raw = [torch.randn(SHAPES["taxi"], generator=gen, device="cuda") * 3 for _ in range(5)]
    args = [narrow_cast(raw[0], d_dt), raw[1].to(cd), *(narrow_cast(x, s_dt) for x in raw[2:])]
    out.append((args, dict(mu_l_next=None if masked else MU_NEXT, t_dtype=None if masked else t_dt), SCALARS))
    edge_kw = dict(mu_l_next=None if masked else hopper_kernels.EDGE_MU_NEXT, t_dtype=None if masked else t_dt)
    if set(key) - {torch.float32, torch.float64}:
        values = hopper_kernels.EDGE_VALUES * 3 + hopper_kernels.EDGE_VALUES[:5]
        out.append((hopper_kernels.edge_args(values, key, "cuda"), edge_kw, hopper_kernels.EDGE_SCALARS))
    for fmt in sorted(set(key) & set(hopper_kernels.FLOAT8), key=str):
        out.append((hopper_kernels.float8_code_args(fmt, key, "cuda"), edge_kw, hopper_kernels.EDGE_SCALARS))
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).contiguous().view(torch.uint8)


def same_bits(a, b) -> bool:
    """Both None, or the same dtype, shape and bytes."""
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def compare_stores(base: Built, other: Built) -> dict[str, list[str]]:
    """variant -> the outputs (and input kinds and entries) where `base` and
    `other` differ in any bit, over every variant both hold and
    `variant_inputs`, through the by-value entry and the pointer entry (the
    penalties as 0-d tensors on the card)."""
    names = ("o", "e", "y_l", "y_o", "nl", "no", "t")
    kinds = ("random", "edges", "codes", "codes")
    differ = {}
    for variant in sorted(set(base.groups) & set(other.groups)):
        wrong = []
        for kind, (args, kw, scalars) in zip(kinds, variant_inputs(variant)):
            on_card = [torch.tensor(x, dtype=args[1].dtype, device="cuda") for x in scalars[:2]]
            pointer_kw = dict(kw, mu_l_next=None if kw["mu_l_next"] is None else
                              torch.tensor(kw["mu_l_next"], dtype=args[1].dtype, device="cuda"))
            for entry, penalties, entry_kw in (("by value", scalars, kw),
                                               ("pointer", (*on_card, scalars[2]), pointer_kw)):
                outs = []
                for built in (base, other):
                    with built:
                        outs.append(hopper_kernels._block_cuda(*args, *penalties, **entry_kw))
                torch.cuda.synchronize()
                wrong += [f"{names[i]} ({kind}, {entry})" for i in range(7) if not same_bits(outs[0][i], outs[1][i])]
        differ[variant] = wrong
    return differ


def quotient_divisors(dtype, presets) -> list[float]:
    """Divisors to hold the kernel's division (`Quotient` in
    csrc/elementwise_block.cuh) to '/' with: each mu_L = mu_O the solves of
    `presets` (TriTDConfig) divide by, as the solver rounds them in `dtype`
    (mu, then min(mu * rho, mu * mu_cap_factor) for max_iter iterations),
    their sums mu_L + mu_O, and at every exponent from -32 to 31 a power of
    two and a significand of all ones, the hardest case for a reciprocal."""
    dt = np.dtype(str(dtype).removeprefix("torch.")).type
    found = set()
    for cfg in presets:
        mu, rho, cap = dt(cfg.mu), dt(cfg.rho), dt(cfg.mu * cfg.mu_cap_factor)
        for _ in range(cfg.max_iter + 1):
            found |= {float(mu), float(mu + mu)}
            mu = np.minimum(mu * rho, cap)
    ones = 2.0 - 2.0 ** -(np.finfo(dt).nmant)
    found |= {float(dt(m * 2.0**k)) for k in range(-32, 32) for m in (1.0, ones)}
    return sorted(found)


def quotient_check(dtype, divisors, count: int, first: int = 0) -> np.ndarray:
    """Run the library's check of the kernel's division (`quotient_check` in
    csrc/elementwise_block.cu) on the current CUDA device: for each divisor,
    the count of numerators whose quotient differs from '/' in any bit, and
    the count that took the reciprocal path, as a (len(divisors), 2) array.
    float32 numerators are the bit patterns first .. first + count - 1 (all
    2**32 with first 0 and count 2**32); float64 ones are `count` drawn from
    a fixed hash."""
    lib = kernels.library()
    ys = torch.tensor(divisors, dtype=dtype, device="cuda")
    counts = torch.zeros(2 * len(divisors), dtype=torch.int64, device="cuda")
    fn = {torch.float32: lib.tritd_quotient_check_f32, torch.float64: lib.tritd_quotient_check_f64}[dtype]
    err = fn(ys.data_ptr(), len(divisors), first, count, counts.data_ptr(),
             torch._C._cuda_getCurrentRawStream(ys.device.index))
    kernels.check(err, "quotient_check launch")
    return counts.view(-1, 2).cpu().numpy()


# The solves of `--solves`: the main path's long ones, then one short solve
# per variant (highway where it rounds to e4m3fn, whose range taxi passes).
LONG_SOLVES = (("taxi", {}, 100), ("video", {}, 100), ("taxi", {"storage_dtype": "float8_e5m2"}, 100),
               ("video", {"storage_dtype": "float8_e5m2"}, 100), ("taxi", {"storage_dtype": "bfloat16"}, 100),
               ("taxi", {"storage_dtype": "float16"}, 100), ("taxi", {"dtype": "float64"}, 20),
               ("taxi", {"storage_dtype": "float8_e5m2", "dtype": "float64"}, 20))
SHORT_ITERS = 10


def variant_solve(variant: str) -> tuple[str, dict]:
    """(dataset, TriTDConfig fields) of a solve that runs `variant`."""
    cd, d_dt, s_dt, t_dt = _key(variant)
    name = lambda dt: str(dt).removeprefix("torch.")  # noqa: E731
    fields = {"dtype": name(cd)}
    if d_dt != cd:
        fields["storage_dtype"] = name(s_dt)
        if t_dt != s_dt:
            fields["einsum_dtype"] = name(t_dt)
    elif s_dt != cd:
        fields.update(storage_dtype=name(s_dt), masked=True)
    elif t_dt != cd:
        fields["einsum_dtype"] = name(t_dt)
    return ("video" if torch.float8_e4m3fn in (d_dt, s_dt, t_dt) else "taxi"), fields


def compare_solves(base: Built, other: Built) -> list[str]:
    """Run LONG_SOLVES and a short solve per variant both builds hold with
    each build's
    kernel; print whether the final A, B, C, O, E, Y_L, Y_O are bitwise equal
    and err_hist's largest relative difference. Returns the solves that
    differ."""
    import dataclasses

    from ..data import load_dataset, uniform_missing_mask
    from ..solvers import TriTDConfig, admm, init_factors, tritd_admm
    from ..utils.config import COMPLETION_TRITD, VIDEO_TRITD

    data = {}
    for name, ds in (("taxi", "taxi"), ("video", "highway")):
        x = torch.as_tensor(load_dataset(ds)[0], dtype=torch.float32, device="cuda")
        mask = torch.as_tensor(uniform_missing_mask(np.random.default_rng(0), tuple(x.shape), 0.10), device="cuda")
        data[name] = (x, mask)
    plan = [(ds, fields, iters) for ds, fields, iters in LONG_SOLVES]
    plan += [(*variant_solve(v), SHORT_ITERS) for v in sorted(set(base.groups) & set(other.groups))]
    real_run, bad = admm.run_admm, []
    for ds, fields, iters in plan:
        x, mask = data[ds]
        base_cfg = COMPLETION_TRITD if ds == "taxi" else VIDEO_TRITD
        cfg = dataclasses.replace(base_cfg, max_iter=iters, **fields)
        masked = cfg.masked or ds == "taxi"
        y = torch.where(mask, x, torch.zeros_like(x)) if masked else x
        init = init_factors(torch.Generator().manual_seed(0), tuple(x.shape), cfg.rank, cfg.torch_dtype())
        finals = []
        for built in (base, other):
            kept = []
            admm.run_admm = lambda *a, **k: kept.append(real_run(*a, **k)) or kept[-1]
            try:
                with built:
                    res = tritd_admm(y, cfg, mask=mask if cfg.masked else None, init=init)
            finally:
                admm.run_admm = real_run
            finals.append((kept[-1], res.err_hist.double().cpu()))
        (sa, ha), (sb, hb) = finals
        fields_differ = [f for f in ("a", "b", "c", "o", "e", "y_l", "y_o") if not same_bits(getattr(sa, f),
                                                                                             getattr(sb, f))]
        both = ha.isnan() & hb.isnan()
        rel = float(torch.where(both, 0.0, (ha - hb).abs() / hb.abs().clamp_min(1e-300)).nan_to_num(1.0).max())
        tag = f"{ds} {fields} {iters} iterations"
        print(f"solve {tag}: state {'bitwise equal' if not fields_differ else 'DIFFERS in ' + str(fields_differ)}"
              f", err_hist max rel diff {rel:.2e}", flush=True)
        if fields_differ or rel > 1e-12:
            bad.append(tag)
    return bad


def print_sass(tag: str, built: Built, sm_mhz: float, out_dir: str | None) -> dict:
    """Print the vector loop's instructions per element of each of
    SASS_VARIANTS in `built` (its hot path by kind, and the whole loop's
    static count), beside the budget at the variant's byte bound; with
    `out_dir`, write each kernel's listing there. Returns the counts."""
    text = cuobjdump_sass(built.path)
    tag_file = re.sub(r"[^A-Za-z0-9]+", "_", tag)[:60]
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
    try:
        loops = sass_loops(text, SASS_VARIANTS, built.groups)
    except (ValueError, RuntimeError) as exc:
        print(f"sass {tag}: not counted: {exc}", flush=True)
        return {}
    for variant, loop in loops.items():
        budget = issue_budget(_case_bytes(variant, "taxi"), sm_mhz)
        per = loop["per_element"]
        static = loop["static"]["total"] / built.groups[variant]
        print(f"sass {tag}: {variant:24s} G={built.groups[variant]:2d} per element, hot path: "
              f"total {per['total']:6.1f} (static {static:6.1f}; budget {budget:5.1f} at {sm_mhz:.0f} MHz) "
              f"fp32 {per['fp32']:5.1f} fp64 {per['fp64']:5.1f} "
              f"(budget {budget / 2:5.1f}) integer {per['integer']:5.1f} convert {per['convert']:5.1f} "
              f"mufu {per['mufu']:4.1f} (with convert, budget {budget / 8:4.1f}) branch {per['branch']:4.1f} "
              f"memory {per['memory']:4.1f} other {per['other']:4.1f}", flush=True)
        if out_dir:
            (Path(out_dir) / f"{tag_file}_{variant}.sass").write_text(loop["function"])
    return {v: {"static": loop["static"], "hot": loop["hot"]} for v, loop in loops.items()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--launches", type=int, default=40, help="launches between two events")
    p.add_argument("--only", nargs="*", default=None, help="substrings of the variations to run")
    p.add_argument("--against", default=None, metavar="FILE",
                   help="also run another revision of the kernel's header (csrc/elementwise_block.cuh) as a "
                        "variation, built with the .cu files beside it")
    p.add_argument("--sass", action="store_true",
                   help="count the vector loop's SASS instructions per element of SASS_VARIANTS in every build")
    p.add_argument("--sass-out", default=None, metavar="DIR", help="write each counted kernel's SASS listing here")
    p.add_argument("--bitwise", action="store_true",
                   help="with --against: every store of every variant both builds hold, on phase 2's kinds "
                        "of inputs, compared bit for bit")
    p.add_argument("--solves", action="store_true",
                   help="with --against: the main path's solves and one per variant both builds hold, final "
                        "state compared bit for bit")
    p.add_argument("--every", action="store_true",
                   help="every variant (taxi, and video where compute is float32) timed four times; with "
                        "--against, those both builds hold in turns, four readings a side")
    p.add_argument("--pointer", action="store_true",
                   help="every variant's pointer entry against its by-value entry at taxi, in turns; with "
                        "--against and --every, every variant's pointer entry of both builds in turns instead")
    p.add_argument("--pointer-variations", action="store_true",
                   help="with --pointer: also each of POINTER_VARIATIONS, the same way")
    p.add_argument("--batch", action="store_true",
                   help=f"every variant's batched entry at {BATCH_ENTRIES}x taxi against {BATCH_ENTRIES} launches "
                        "of its pointer entry, in turns, after holding every entry's stores bitwise")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    text = SOURCE.read_text()
    result = {"card": card, "variations": [], "sass": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        base = Built("as built", text, {}, tmp)
        result["registers"] = base.registers
        for row in base.registers:
            print(f"as built: kernel<{row['kernel_types_c_d_s_t']}> {row['registers']} registers, "
                  f"{row['spill_bytes']} bytes spilled")
        with base:
            result["host"] = host_times()
        print("host us per call: " + ", ".join(f"{k} {v:.1f}" for k, v in result["host"].items()), flush=True)
        cases = {case: make_case(*case) for case in CASES}
        if a.sass:
            with base:
                again, _got = launch_again(*cases[("c32_de5m2_se5m2_te5m2", "video")][:2])
                sm_mhz, max_mhz = sm_clock_during(again)
            print(f"SM clock under load {sm_mhz:.0f} MHz (max {max_mhz:.0f})")
            result["sm_mhz"] = sm_mhz
            result["sass"]["as built"] = print_sass("as built", base, sm_mhz, a.sass_out)
        if a.pointer and not a.against:
            mine = Built("as built, every variant", text, {}, tmp, set(hopper_kernels.KERNEL_VARIANTS.values()))
            result["pointer_registers"] = mine.registers
            for row in mine.registers:
                print(f"every variant: kernel<{row['kernel_types_c_d_s_t']}> {row['registers']} registers, "
                      f"{row['spill_bytes']} bytes spilled")
            rows = pointer_turns(mine, a.launches)
            result["pointer"] = rows
            print_pointer_summary("pointer", rows)
            for name, subs in (POINTER_VARIATIONS.items() if a.pointer_variations else ()):
                other = Built(name, vary(text, subs), {}, tmp, set(hopper_kernels.KERNEL_VARIANTS.values()))
                spills = [r for r in other.registers if r["spill_bytes"]]
                print(f"{name}: spills " + (", ".join(f"kernel<{r['kernel_types_c_d_s_t']}> {r['spill_bytes']} bytes"
                                                       for r in spills) or "none"))
                result.setdefault("pointer_variations", {})[name] = pointer_turns(other, a.launches)
                print_pointer_summary(name, result["pointer_variations"][name])
        if a.every and not a.against:
            mine = Built("as built, every variant", text, {}, tmp, set(hopper_kernels.KERNEL_VARIANTS.values()))
            result["turns"] = time_in_turns(mine, None, a.launches)
        if a.batch:
            mine = Built("as built, every variant, batched", text, {}, tmp,
                         set(hopper_kernels.KERNEL_VARIANTS.values()))
            result["batch_registers"] = mine.registers
            for row in mine.registers:
                print(f"every variant: kernel<{row['kernel_types_c_d_s_t']}> {row['registers']} registers, "
                      f"{row['spill_bytes']} bytes spilled")
            rows = batch_turns(mine, a.launches)
            result["batch"] = rows
            beyond = [r["variant"] for r in rows if abs(r["change"]) > max(r["batch_spread"], r["pointer_spread"])]
            print(f"batch: {len(rows)} variants, every entry bitwise; median change against {BATCH_ENTRIES} pointer "
                  f"launches {np.median([r['change'] for r in rows]):+.2%}, from "
                  f"{min(r['change'] for r in rows):+.1%} to {max(r['change'] for r in rows):+.1%}; "
                  f"{len(beyond)} beyond both sides' spread", flush=True)
        if a.against and (a.bitwise or a.solves or a.every):
            every = set(hopper_kernels.KERNEL_VARIANTS.values())
            mine = Built("as built, every variant", text, {}, tmp, every)
            theirs = Built(f"{a.against}, every variant", Path(a.against).read_text(), {}, tmp, every,
                           Path(a.against).parent)
            if a.bitwise:
                differ = compare_stores(mine, theirs)
                result["bitwise"] = differ
                for variant, wrong in differ.items():
                    print(f"bitwise {variant:24s} against {a.against}: "
                          + ("every store and both sums equal" if not wrong else f"DIFFER: {wrong}"), flush=True)
                print(f"bitwise: {sum(not w for w in differ.values())} of {len(differ)} variants equal in every bit")
            if a.solves:
                result["solves_differ"] = compare_solves(mine, theirs)
                print(f"solves differing from {a.against}: {result['solves_differ'] or 'none'}")
            for pointer in (False, True) if a.every and a.pointer else (False,) if a.every else ():
                rows = time_in_turns(mine, theirs, a.launches, pointer)
                result["pointer_turns" if pointer else "turns"] = rows
                rows = [r for r in rows if "change" in r]
                slow = max(rows, key=lambda r: r["change"])
                spread = max(max(r["spread"], r["against_spread"]) for r in rows)
                beyond = sum(abs(r["change"]) > max(r["spread"], r["against_spread"]) for r in rows)
                print(f"turns{' (pointer entries)' if pointer else ''}: {len(rows)} cases; median change "
                      f"{np.median([r['change'] for r in rows]):+.2%}; slowest against {a.against}: {slow['variant']} "
                      f"{slow['shape']} {slow['change']:+.1%}; largest spread {spread:.1%}; {beyond} beyond both "
                      f"sides' spread", flush=True)
        variations = dict(VARIATIONS)
        if a.against:
            variations[f"the source {a.against}"] = (None, {}, True)
        for name, (subs, overrides, sums_valid) in variations.items():
            if a.only is not None and subs is not None and not any(s in name for s in a.only):
                continue
            try:
                if subs is None:
                    varied = Built(name, Path(a.against).read_text(), overrides, tmp, src_dir=Path(a.against).parent)
                else:
                    varied = Built(name, vary(text, subs), overrides, tmp)
            except RuntimeError as exc:  # a variation that does not build leaves the others to run
                print(f"{name}: FAILED to build: {str(exc)[-2000:]}", flush=True)
                result["variations"].append({"variation": name, "error": str(exc)[-2000:]})
                continue
            spilled = {r["kernel_types_c_d_s_t"]: r["spill_bytes"] for r in varied.registers if r["spill_bytes"]}
            print(f"{name}: registers {[r['registers'] for r in varied.registers]}, spills {spilled or 'none'}"
                  + ("" if sums_valid else "; its results differ from the source's: timed with the check off"))
            if a.sass:
                result["sass"][name] = print_sass(name, varied, result["sm_mhz"], a.sass_out)
            for case, (args, kw, plain) in cases.items():
                turns = [measure(b, args, kw, plain, a.launches, ok)
                         for b, ok in ((base, True), (varied, sums_valid), (varied, sums_valid), (base, True))]
                us = [t[0] for t in turns]
                per = block_bytes_per_element(args[0].dtype, args[1].dtype, args[2].dtype,
                                              None if kw["mu_l_next"] is None else kw["t_dtype"])
                bound = per * args[0].numel() / PEAK_BYTES_PER_S * 1e6
                result["variations"].append({"variation": name, "variant": case[0], "shape": case[1],
                                             "bytes_per_element": per, "bound_us": bound,
                                             "as_built_us": [us[0], us[3]], "varied_us": [us[1], us[2]],
                                             "max_abs_err": max(t[1] for t in turns)})
                print(f"  {case[0]:24s} {case[1]:6s} {per:2d} B/elem, bound {bound:6.1f} us: as built {us[0]:7.1f} "
                      f"{us[3]:7.1f} us, varied {us[1]:7.1f} {us[2]:7.1f} us "
                      f"({(us[1] + us[2]) / (us[0] + us[3]) - 1:+.1%})" + ("" if sums_valid else " [check off]"),
                      flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {a.out}")
    return result


if __name__ == "__main__":
    main()
