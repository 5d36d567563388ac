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

Needs a CUDA device and nvcc. Usage:
    python -m tritd_tpu_torch.tools.sweep_block [--launches 40] [--only NAME ...] [--out result.json]
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
         ("c32_de5m2_se5m2_te5m2", "video"), ("c64_de5m2_se5m2_te5m2", "taxi"))


def _geometry(threads: int, per_sm: int) -> dict:
    resident = 132 * per_sm
    return {"BLOCK_THREADS": threads, "RESIDENT_BLOCKS": resident, "SCRATCH_LEN": 2 * resident + 1}


def _old_grid(n: int, group: int) -> int:
    return min(max(1, -(-(-(-n // group)) // 256)), 2048)


def _groups(by_stream: int) -> dict:
    def group_size(compute_size, narrowest_size):
        return min(by_stream // narrowest_size, 32 // compute_size)
    return {"group_size": group_size,
            "VARIANT_GROUP": {v: group_size(c.itemsize, min(dt.itemsize for dt in rest))
                              for (c, *rest), v in hopper_kernels.KERNEL_VARIANTS.items()}}


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
        [("kByStream = 16 / kNarrowest;", "kByStream = 32 / kNarrowest;", 1)], _groups(32), True),
}


def _unit_files(variants) -> list[Path]:
    """The package's .cu files that hold an entry point of `variants`, and
    elementwise_block.cu (the geometry the wrapper checks)."""
    return [src for src in build.sources()
            if src.name == "elementwise_block.cu" or set(ENTRY.findall(src.read_text())) & set(variants)]


def _demangle(names: list[str]) -> list[str]:
    """C++ names through c++filt where it is installed, else as they are."""
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    return subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()


def compile_source(text: str, out_dir: Path, tag: str, variants) -> tuple[Path, list[dict], list[str]]:
    """Compile `text` as the kernel's header with the .cu files that hold
    `variants`, with the package's flags plus -Xptxas -v; returns the
    library, one {kernel, registers, spill_bytes} per instantiation, and
    the variants the library holds."""
    unit_dir = out_dir / tag
    unit_dir.mkdir()
    (unit_dir / SOURCE.name).write_text(text)
    units = [Path(shutil.copy(src, unit_dir)) for src in _unit_files(variants)]
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
    """A compiled copy of the kernel with the plan overrides that go with it."""

    def __init__(self, name, text, overrides, out_dir):
        self.name, self.overrides = name, overrides
        variants = {variant for variant, _shape in CASES}
        path, self.registers, held = compile_source(text, out_dir, re.sub(r"\W+", "_", name), variants)
        self.lib = kernels.bind(path, variants=held)

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
        hopper_kernels._SCRATCH.clear()


def vary(text: str, subs) -> str:
    for old, new, count in subs:
        if text.count(old) != count:
            raise RuntimeError(f"{old!r} occurs {text.count(old)} times in {SOURCE.name}, not {count}")
        text = text.replace(old, new)
    return text


def make_case(variant: str, shape_name: str):
    (cd, d_dt, s_dt, t_dt), = (k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    if d_dt == cd and s_dt != cd:
        t_dt = None  # masked narrow storage carries no T'
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = SHAPES.get(shape_name) or SLAB_SHAPES[shape_name]
    raw = [torch.randn(shape, generator=gen, device="cuda") * 3 for _ in range(5)]
    args = [narrow_cast(raw[0], d_dt), raw[1].to(cd), *(narrow_cast(x, s_dt) for x in raw[2:])]
    kw = dict(mu_l_next=None if t_dt is None else MU_NEXT, t_dtype=t_dt)
    plain = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=kw["mu_l_next"], compute_dtype=cd,
                                        store_dtype=s_dt, t_dtype=t_dt)
    return args, kw, plain


def launch_again(args, kw):
    """One wrapper call; returns a function that repeats its launch of the C
    entry point with the same arguments, and the call's outputs (which keep
    the buffers alive)."""
    real, seen = hopper_kernels._entry, {}

    def spy(variant):
        fn, group, key = real(variant)

        def record(*argv):
            seen["again"] = lambda: fn(*argv)
            return fn(*argv)
        return record, group, key

    hopper_kernels._entry = spy
    try:
        got = hopper_kernels._block_cuda(*args, *SCALARS, **kw)
    finally:
        hopper_kernels._entry = real
    return seen["again"], got


def measure(built: Built, args, kw, plain, launches: int, sums_valid: bool) -> tuple[float, float]:
    """(device us per launch, largest |kernel - plain| over the outputs)."""
    with built:
        again, got = launch_again(args, kw)
        torch.cuda.synchronize()
        idx = [i for i in (0, 1, 2, 3, 6) if got[i] is not None]
        worst = max(float((got[i].double() - plain[i].double()).abs().nan_to_num().max()) for i in idx)
        if sums_valid:
            for i in (4, 5):
                torch.testing.assert_close(got[i], plain[i], rtol=1e-5, atol=0.0)
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                again()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / launches * 1e3)
    return sorted(times)[2], worst


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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--launches", type=int, default=40, help="launches between two events")
    p.add_argument("--only", nargs="*", default=None, help="substrings of the variations to run")
    p.add_argument("--against", default=None, metavar="FILE",
                   help="also run another revision of the kernel's header (csrc/elementwise_block.cuh) as a variation")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    text = SOURCE.read_text()
    result = {"card": card, "variations": []}
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
        variations = dict(VARIATIONS)
        if a.against:
            variations[f"the source {a.against}"] = (None, {}, True)
        for name, (subs, overrides, sums_valid) in variations.items():
            if a.only is not None and subs is not None and not any(s in name for s in a.only):
                continue
            varied = Built(name, Path(a.against).read_text() if subs is None else vary(text, subs), overrides, tmp)
            spilled = {r["kernel_types_c_d_s_t"]: r["spill_bytes"] for r in varied.registers if r["spill_bytes"]}
            print(f"{name}: registers {[r['registers'] for r in varied.registers]}, spills {spilled or 'none'}")
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
                      f"({(us[1] + us[2]) / (us[0] + us[3]) - 1:+.1%})", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {a.out}")
    return result


if __name__ == "__main__":
    main()
