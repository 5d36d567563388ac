"""Method-level Tensor Toolbox parity audit of the port.

Counterpart of the JAX package's `tools/toolbox_audit.py`. It keeps its own
copy of the method table `M`: every method file of the Tensor Toolbox v3.1
class directories (``@tensor``, ``@sptensor``, ``@ktensor``, ``@ttensor``,
``@tenmat``, ``@sptenmat``, ``@symtensor``, ``@symktensor``,
``@sumtensor``) mapped to its counterpart in
:mod:`tritd_tpu_torch.ops.classes`, or to a justified n/a. Two guarantees:

1. **No rot**: every ``Class.attr`` target resolves by ``getattr`` against
   the port's classes (or tiny instances of them, built on the CPU, for
   attributes set in ``__init__``); a mapping to a missing symbol is a
   problem.
2. **No gaps**: the list of method files is the one the reference's audit
   generated from the toolbox sources, the rows of
   ``docs/TOOLBOX_PARITY.md`` (read, never written: the toolbox sources are
   not part of this repository). A file without a mapping, a mapping
   without a file, or a row whose kind (implemented or n/a) differs from
   the reference's is a problem.

Run: python -m tritd_tpu_torch.tools.toolbox_audit --check
     prints ``ok (<impl> impl, <n/a> n/a)`` and exits 0, or prints each
     problem and exits 1; ``--out PATH`` also writes the port's table there.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

#: the reference's generated map; its rows are the method files to audit.
#: It lies in the repository's docs/, so the audit runs from a checkout.
PARITY_DOC = Path(__file__).resolve().parents[2] / "docs" / "TOOLBOX_PARITY.md"

# Map: class dir -> method name -> (kind, target, note)
#   kind "impl": target is "Class.attr" resolved against ops/classes.py
#   kind "na":   target is the justification (display/plot plumbing etc.)
_DISPLAY = ("na", "terminal pretty-printer; `__repr__` covers the class face")

M = {
    "@tensor": {
        "tensor": ("impl", "Tensor.__init__", "constructor"),
        "and": ("impl", "Tensor.logical_and", ""),
        "or": ("impl", "Tensor.logical_or", ""),
        "not": ("impl", "Tensor.logical_not", ""),
        "xor": ("impl", "Tensor.logical_xor", ""),
        "collapse": ("impl", "Tensor.collapse", ""),
        "contract": ("impl", "Tensor.contract", ""),
        "disp": _DISPLAY,
        "display": _DISPLAY,
        "double": ("impl", "Tensor.double", ""),
        "end": ("impl", "Tensor.__getitem__", "MATLAB `end` = negative index"),
        "eq": ("impl", "Tensor.__eq__", ""),
        "ne": ("impl", "Tensor.__ne__", ""),
        "lt": ("impl", "Tensor.__lt__", ""),
        "le": ("impl", "Tensor.__le__", ""),
        "gt": ("impl", "Tensor.__gt__", ""),
        "ge": ("impl", "Tensor.__ge__", ""),
        "exp": ("impl", "Tensor.exp", ""),
        "find": ("impl", "Tensor.find", ""),
        "full": ("impl", "Tensor.full", ""),
        "innerprod": ("impl", "Tensor.innerprod", ""),
        "isequal": ("impl", "Tensor.isequal", ""),
        "isscalar": ("impl", "Tensor.isscalar", ""),
        "issymmetric": ("impl", "Tensor.issymmetric", ""),
        "ldivide": ("impl", "Tensor.__rtruediv__", "elementwise A.\\B = B./A"),
        "rdivide": ("impl", "Tensor.__truediv__", ""),
        "mask": ("impl", "Tensor.mask", ""),
        "minus": ("impl", "Tensor.__sub__", ""),
        "plus": ("impl", "Tensor.__add__", ""),
        "mldivide": ("impl", "Tensor.mldivide", "scalar left-divide"),
        "mrdivide": ("impl", "Tensor.mrdivide", "scalar right-divide"),
        "mtimes": ("impl", "Tensor.__mul__", "scalar scaling (toolbox mtimes is scalar-only)"),
        "times": ("impl", "Tensor.__mul__", ""),
        "mttkrp": ("impl", "Tensor.mttkrp", ""),
        "mttkrps": ("impl", "Tensor.mttkrps", ""),
        "ndims": ("impl", "Tensor.ndim", ""),
        "nnz": ("impl", "Tensor.nnz", ""),
        "norm": ("impl", "Tensor.norm", ""),
        "nvecs": ("impl", "Tensor.nvecs", ""),
        "permute": ("impl", "Tensor.permute", ""),
        "power": ("impl", "Tensor.__pow__", ""),
        "reshape": ("impl", "Tensor.reshape", ""),
        "scale": ("impl", "Tensor.scale", ""),
        "size": ("impl", "Tensor.shape", ""),
        "squeeze": ("impl", "Tensor.squeeze", ""),
        "subsasgn": ("impl", "Tensor.with_set", "functional assignment"),
        "subsref": ("impl", "Tensor.__getitem__", ""),
        "symmetrize": ("impl", "Tensor.symmetrize", ""),
        "tenfun": ("impl", "Tensor.tenfun", ""),
        "transpose": (
            "na",
            "`@tensor/transpose.m` errors by design ('not defined on tensors'); permute is the supported op",
        ),
        "ttm": ("impl", "Tensor.ttm", ""),
        "ttsv": ("impl", "Tensor.ttsv", ""),
        "ttt": ("impl", "Tensor.ttt", ""),
        "ttv": ("impl", "Tensor.ttv", ""),
        "uminus": ("impl", "Tensor.__neg__", ""),
        "uplus": ("impl", "Tensor.__pos__", ""),
    },
    "@sptensor": {
        "sptensor": ("impl", "SpTensor.__init__", "COO constructor"),
        "and": ("impl", "SpTensor.logical_and", ""),
        "or": ("impl", "SpTensor.logical_or", ""),
        "not": ("impl", "SpTensor.logical_not", ""),
        "xor": ("impl", "SpTensor.logical_xor", ""),
        "collapse": ("impl", "SpTensor.collapse", "sum stays sparse-native"),
        "contract": ("impl", "SpTensor.contract", "sparse-native"),
        "disp": _DISPLAY,
        "display": _DISPLAY,
        "divide": ("impl", "SpTensor.divide", "by nonneg ktensor at nonzeros"),
        "double": ("impl", "SpTensor.double", ""),
        "elemfun": ("impl", "SpTensor.elemfun", ""),
        "end": ("impl", "SpTensor.__getitem__", "negative index"),
        "eq": ("impl", "SpTensor.__eq__", "dense-bool result, as the reference"),
        "ne": ("impl", "SpTensor.__ne__", ""),
        "lt": ("impl", "SpTensor.__lt__", ""),
        "le": ("impl", "SpTensor.__le__", ""),
        "gt": ("impl", "SpTensor.__gt__", ""),
        "ge": ("impl", "SpTensor.__ge__", ""),
        "find": ("impl", "SpTensor.find", ""),
        "full": ("impl", "SpTensor.full", ""),
        "innerprod": ("impl", "SpTensor.innerprod", ""),
        "isequal": ("impl", "SpTensor.isequal", ""),
        "isscalar": ("impl", "SpTensor.isscalar", ""),
        "ldivide": ("impl", "SpTensor.mldivide", "scalar-only in the toolbox"),
        "rdivide": ("impl", "SpTensor.__truediv__", ""),
        "mask": ("impl", "SpTensor.mask", ""),
        "minus": ("impl", "SpTensor.__sub__", ""),
        "plus": ("impl", "SpTensor.__add__", ""),
        "mldivide": ("impl", "SpTensor.mldivide", ""),
        "mrdivide": ("impl", "SpTensor.mrdivide", ""),
        "mtimes": ("impl", "SpTensor.__mul__", "scalar scaling"),
        "times": ("impl", "SpTensor.__mul__", "elementwise; stays sparse"),
        "mttkrp": ("impl", "SpTensor.mttkrp", "O(nnz·R) scatter"),
        "ndims": ("impl", "SpTensor.ndim", ""),
        "nnz": ("impl", "SpTensor.nnz", ""),
        "norm": ("impl", "SpTensor.norm", ""),
        "nvecs": ("impl", "SpTensor.nvecs", ""),
        "ones": ("impl", "SpTensor.ones", ""),
        "spones": ("impl", "SpTensor.spones", ""),
        "permute": ("impl", "SpTensor.permute", ""),
        "private": ("na", "MATLAB private helper dir (allsubs/irenumber…), not a public method"),
        "reshape": ("impl", "SpTensor.reshape", "linear-index remap"),
        "scale": ("impl", "SpTensor.scale", ""),
        "size": ("impl", "SpTensor.shape", ""),
        "spmatrix": ("impl", "SpTensor.spmatrix", "the assembled dense matrix, as the reference returns"),
        "squeeze": ("impl", "SpTensor.squeeze", ""),
        "subsasgn": ("impl", "SpTensor.with_set", "replace semantics, host-side"),
        "subsref": ("impl", "SpTensor.__getitem__", "sparse-native single lookup"),
        "ttm": ("impl", "SpTensor.ttm", "one index_add_ scatter-GEMM"),
        "ttt": ("impl", "SpTensor.ttt", "sparse outer / dense contraction"),
        "ttv": ("impl", "SpTensor.ttv", ""),
        "uminus": ("impl", "SpTensor.__neg__", ""),
        "uplus": ("impl", "SpTensor.__pos__", ""),
    },
    "@ktensor": {
        "ktensor": ("impl", "KTensor.__init__", "constructor (+ from_vec)"),
        "arrange": ("impl", "KTensor.arrange", ""),
        "datadisp": _DISPLAY,
        "disp": _DISPLAY,
        "display": _DISPLAY,
        "double": ("impl", "KTensor.double", ""),
        "end": ("na", "`@ktensor/end.m` only supports factor subscripts; use .factors[-1]"),
        "extract": ("impl", "KTensor.extract", "component subset"),
        "fixsigns": ("impl", "KTensor.fixsigns", ""),
        "full": ("impl", "KTensor.full", ""),
        "innerprod": ("impl", "KTensor.innerprod", ""),
        "isequal": ("impl", "KTensor.isequal", "structural"),
        "isscalar": ("impl", "KTensor.isscalar", ""),
        "issymmetric": ("impl", "KTensor.issymmetric", ""),
        "mask": ("impl", "KTensor.mask", "never densifies for sparse W"),
        "minus": ("impl", "KTensor.__sub__", ""),
        "plus": ("impl", "KTensor.__add__", "component concat"),
        "mtimes": ("impl", "KTensor.__mul__", "scalar on λ"),
        "times": ("impl", "KTensor.times", "elementwise; sparse stays sparse"),
        "mttkrp": ("impl", "KTensor.mttkrp", "small-Gram identity"),
        "ncomponents": ("impl", "KTensor.ncomponents", ""),
        "ndims": ("impl", "KTensor.ndim", ""),
        "norm": ("impl", "KTensor.norm", ""),
        "normalize": ("impl", "KTensor.normalize", ""),
        "nvecs": ("impl", "KTensor.nvecs", "Gram-factorized eigh"),
        "permute": ("impl", "KTensor.permute", ""),
        "redistribute": ("impl", "KTensor.redistribute", ""),
        "score": ("impl", "KTensor.score", ""),
        "size": ("impl", "KTensor.shape", ""),
        "subsasgn": ("impl", "KTensor.update", "functional factor replacement"),
        "subsref": ("impl", "KTensor.tocell", "+ .weights/.factors attributes"),
        "symmetrize": ("impl", "KTensor.symmetrize", ""),
        "tocell": ("impl", "KTensor.tocell", ""),
        "tovec": ("impl", "KTensor.tovec", ""),
        "ttm": ("impl", "KTensor.ttm", "stays Kruskal"),
        "ttv": ("impl", "KTensor.ttv", "stays Kruskal"),
        "uminus": ("impl", "KTensor.__neg__", ""),
        "uplus": ("impl", "KTensor.__pos__", ""),
        "update": ("impl", "KTensor.update", "vector-of-unknowns interface"),
        "viz": ("na", "MATLAB factor-plot figure; out of scope like all plotting"),
    },
    "@ttensor": {
        "ttensor": ("impl", "TTensor.__init__", "constructor"),
        "disp": _DISPLAY,
        "display": _DISPLAY,
        "double": ("impl", "TTensor.double", ""),
        "end": ("impl", "TTensor.__getitem__", "negative index"),
        "full": ("impl", "TTensor.full", ""),
        "innerprod": ("impl", "TTensor.innerprod", "factors pulled onto operand"),
        "isequal": ("impl", "TTensor.isequal", ""),
        "isscalar": ("impl", "TTensor.isscalar", ""),
        "mtimes": ("impl", "TTensor.__mul__", "scalar on the core"),
        "mttkrp": ("impl", "TTensor.mttkrp", "through the small core"),
        "ndims": ("impl", "TTensor.ndim", ""),
        "norm": ("impl", "TTensor.norm", ""),
        "nvecs": ("impl", "TTensor.nvecs", "Gram through the core"),
        "permute": ("impl", "TTensor.permute", ""),
        "size": ("impl", "TTensor.shape", ""),
        "subsasgn": ("na", "immutable value type; construct a new TTensor(core, factors)"),
        "subsref": ("impl", "TTensor.__getitem__", "entry via factor-row ttv"),
        "ttm": ("impl", "TTensor.ttm", "absorbed into factors"),
        "ttv": ("impl", "TTensor.ttv", "contracted into the core"),
        "uminus": ("impl", "TTensor.__neg__", ""),
        "uplus": ("impl", "TTensor.__pos__", ""),
    },
    "@tenmat": {
        "tenmat": ("impl", "TenMat.__init__", "+ TenMat.from_tensor"),
        "ctranspose": ("impl", "TenMat.T", ""),
        "disp": _DISPLAY,
        "display": _DISPLAY,
        "double": ("impl", "TenMat.double", ""),
        "end": ("impl", "TenMat.__getitem__", "negative index"),
        "minus": ("impl", "TenMat.__sub__", ""),
        "plus": ("impl", "TenMat.__add__", ""),
        "mtimes": ("impl", "TenMat.__mul__", "tsize-propagating matmul"),
        "norm": ("impl", "TenMat.norm", ""),
        "size": ("impl", "TenMat.shape", ""),
        "subsasgn": ("impl", "TenMat.with_set", ""),
        "subsref": ("impl", "TenMat.__getitem__", ""),
        "tsize": ("impl", "TenMat.tsize", ""),
        "uminus": ("impl", "TenMat.__neg__", ""),
        "uplus": ("impl", "TenMat.__pos__", ""),
    },
    "@sptenmat": {
        "sptenmat": ("impl", "SpTenMat.__init__", "+ SpTensor.to_sptenmat"),
        "aatx": ("impl", "SpTenMat.aatx", "matrix-free A·Aᵀ·x, O(nnz)"),
        "disp": _DISPLAY,
        "display": _DISPLAY,
        "double": ("impl", "SpTenMat.double", ""),
        "end": ("na", "only meaningful through double(); use negative index there"),
        "full": ("impl", "SpTenMat.full", ""),
        "nnz": ("impl", "SpTenMat.nnz", ""),
        "norm": ("impl", "SpTenMat.norm", ""),
        "size": ("impl", "SpTenMat.shape", ""),
        "subsasgn": ("na", "immutable; construct a new SpTenMat with edited triples"),
        "subsref": ("na", "stored-triple access = .vals/.row_idx/.col_idx attributes"),
        "tsize": ("impl", "SpTenMat.tsize", ""),
        "uminus": ("impl", "SpTenMat.__neg__", ""),
        "uplus": ("impl", "SpTenMat.__pos__", ""),
    },
    "@symtensor": {
        "symtensor": ("impl", "SymTensor.__init__", "constructor (symmetrizes)"),
        "and": ("impl", "SymTensor.logical_and", ""),
        "or": ("impl", "SymTensor.logical_or", ""),
        "not": ("impl", "SymTensor.logical_not", ""),
        "xor": ("impl", "SymTensor.logical_xor", ""),
        "disp": _DISPLAY,
        "display": _DISPLAY,
        "eq": ("impl", "SymTensor.__eq__", ""),
        "ne": ("impl", "SymTensor.__ne__", ""),
        "lt": ("impl", "SymTensor.__lt__", ""),
        "le": ("impl", "SymTensor.__le__", ""),
        "gt": ("impl", "SymTensor.__gt__", ""),
        "ge": ("impl", "SymTensor.__ge__", ""),
        "full": ("impl", "SymTensor.full", ""),
        "indices": ("impl", "SymTensor.indices", "distinct monomials (+ .vals())"),
        "isequal": ("impl", "SymTensor.isequal", ""),
        "isscalar": ("impl", "SymTensor.isscalar", ""),
        "issymmetric": ("impl", "SymTensor.issymmetric", ""),
        "ldivide": ("impl", "SymTensor.__rtruediv__", ""),
        "rdivide": ("impl", "SymTensor.__truediv__", ""),
        "minus": ("impl", "SymTensor.__sub__", ""),
        "plus": ("impl", "SymTensor.__add__", ""),
        "mldivide": ("impl", "SymTensor.mldivide", ""),
        "mrdivide": ("impl", "SymTensor.mrdivide", ""),
        "mtimes": ("impl", "SymTensor.__mul__", "scalar"),
        "times": ("impl", "SymTensor.__mul__", ""),
        "ndims": ("impl", "SymTensor.ndim", ""),
        "power": ("impl", "SymTensor.__pow__", ""),
        "private": ("na", "MATLAB private helper dir, not a public method"),
        "size": ("impl", "SymTensor.shape", ""),
        "subsasgn": ("impl", "SymTensor.with_set", "writes every symmetric copy"),
        "subsref": ("impl", "SymTensor.__getitem__", ""),
        "tenfun": ("impl", "SymTensor.tenfun", ""),
        "uminus": ("impl", "SymTensor.__neg__", ""),
        "uplus": ("impl", "SymTensor.__pos__", ""),
    },
    "@symktensor": {
        "symktensor": ("impl", "SymKTensor.__init__", "constructor (+ from_vec)"),
        "arrange": ("impl", "SymKTensor.arrange", ""),
        "disp": _DISPLAY,
        "display": _DISPLAY,
        "double": ("impl", "SymKTensor.double", ""),
        "end": ("na", "subscript sugar over entry(); entry() is the API"),
        "entry": ("impl", "SymKTensor.entry", ""),
        "fg": ("impl", "SymKTensor.fg", "fast-path F/G, autodiff-pinned"),
        "fg_setup": ("impl", "SymKTensor.fg_setup", ""),
        "full": ("impl", "SymKTensor.full", ""),
        "isequal": ("impl", "SymKTensor.isequal", ""),
        "isscalar": ("impl", "SymKTensor.isscalar", ""),
        "issymmetric": ("impl", "SymKTensor.issymmetric", ""),
        "mtimes": ("impl", "SymKTensor.__mul__", "scalar on λ"),
        "ncomponents": ("impl", "SymKTensor.ncomponents", ""),
        "ndims": ("impl", "SymKTensor.ndim", ""),
        "norm": ("impl", "SymKTensor.norm", "Gram identity, no densify"),
        "normalize": ("impl", "SymKTensor.normalize", ""),
        "permute": ("impl", "SymKTensor.permute", "identity by symmetry"),
        "score": ("impl", "SymKTensor.score", ""),
        "size": ("impl", "SymKTensor.shape", ""),
        "subsasgn": ("na", "immutable; from_vec is the mutation interface"),
        "subsref": ("impl", "SymKTensor.entry", "+ .weights/.u attributes"),
        "tovec": ("impl", "SymKTensor.tovec", ""),
        "uminus": ("impl", "SymKTensor.__neg__", ""),
        "uplus": ("impl", "SymKTensor.__pos__", ""),
    },
    "@sumtensor": {
        "sumtensor": ("impl", "SumTensor.__init__", "constructor"),
        "disp": _DISPLAY,
        "display": _DISPLAY,
        "double": ("impl", "SumTensor.double", ""),
        "full": ("impl", "SumTensor.full", ""),
        "innerprod": ("impl", "SumTensor.innerprod", "distributes over parts"),
        "isscalar": ("impl", "SumTensor.isscalar", ""),
        "mttkrp": ("impl", "SumTensor.mttkrp", "distributes over parts"),
        "ndims": ("impl", "SumTensor.ndim", ""),
        "norm": ("impl", "SumTensor.norm", ""),
        "plus": ("impl", "SumTensor.__add__", ""),
        "size": ("impl", "SumTensor.shape", ""),
        "subsref": ("na", "part access = .parts list attribute"),
        "ttv": ("impl", "SumTensor.ttv", "distributes over parts"),
        "uminus": ("impl", "SumTensor.__neg__", ""),
        "uplus": ("impl", "SumTensor.__pos__", ""),
    },
}


def reference_rows(path: Path = PARITY_DOC) -> dict:
    """{class dir: {method: "impl" or "na"}} from the rows of the
    reference's generated table."""
    if not path.is_file():
        raise FileNotFoundError(
            f"the reference's method table {path} is missing: the audit reads docs/TOOLBOX_PARITY.md "
            "of a checkout of the repository, so run it from one (or an editable install)"
        )
    rows: dict = {}
    cdir = None
    for line in path.read_text().splitlines():
        head = re.match(r"^## (@\w+)\s*$", line)
        if head:
            cdir = head.group(1)
            rows[cdir] = {}
            continue
        row = re.match(r"^\| `([^`]+)\.m` \| (.*?) \|", line)
        if row and cdir is not None:
            rows[cdir][row.group(1)] = "na" if row.group(2).strip() == "n/a" else "impl"
    return rows


def _instances() -> dict:
    """Tiny instances of every class on the CPU, so mapped symbols resolve
    whether they are methods, properties or attributes set in __init__."""
    import numpy as np

    from ..ops import classes as C

    cpu = "cpu"
    t = C.Tensor(np.zeros((2, 2, 2), np.float32), device=cpu)
    sp = C.SpTensor(np.ones((1,), np.float32), np.zeros((1, 3), np.int64), (2, 2, 2), device=cpu)
    return {
        "Tensor": t,
        "SpTensor": sp,
        "KTensor": C.KTensor([np.ones((2, 1), np.float32)] * 3, device=cpu),
        "TTensor": C.TTensor(np.ones((1, 1, 1), np.float32), [np.ones((2, 1), np.float32)] * 3, device=cpu),
        "SymTensor": C.SymTensor(np.zeros((2, 2, 2), np.float32), device=cpu),
        "SymKTensor": C.SymKTensor(np.ones((1,), np.float32), np.ones((2, 1), np.float32), 3, device=cpu),
        "SumTensor": C.SumTensor([t]),
        "TenMat": C.TenMat.from_tensor(np.zeros((2, 2, 2), np.float32), (0,), device=cpu),
        "SpTenMat": sp.to_sptenmat((0,)),
    }


def audit(doc: Path = PARITY_DOC):
    """(rows by class, implemented count, n/a count, problems)."""
    from ..ops import classes as C

    inst = _instances()
    ref = reference_rows(doc)
    problems = []
    rows_by_class = {}
    n_impl = n_na = 0
    for cdir in list(M) + [c for c in ref if c not in M]:
        table, on_disk = M.get(cdir, {}), ref.get(cdir, {})
        if cdir not in ref:
            problems.append(f"{cdir}: no such class in {doc.name}")
        rows = []
        for meth, ref_kind in on_disk.items():
            if meth not in table:
                problems.append(f"{cdir}/{meth}.m has no mapping")
                continue
            kind, target, *rest = table[meth]
            note = rest[0] if rest else ""
            if kind != ref_kind:
                problems.append(f"{cdir}/{meth}.m is {kind} here and {ref_kind} in the reference")
            if kind == "impl":
                cls_name, attr = target.split(".", 1)
                cls = getattr(C, cls_name, None)
                if cls is None or not (hasattr(cls, attr) or hasattr(inst[cls_name], attr)):
                    problems.append(f"{cdir}/{meth}.m maps to missing symbol {target}")
                rows.append((meth, f"`ops/classes.py::{target}`", note))
                n_impl += 1
            else:
                rows.append((meth, "n/a", target if not note else f"{target} — {note}"))
                n_na += 1
        for meth in sorted(set(table) - set(on_disk)):
            problems.append(f"{cdir}: mapping for {meth} has no reference file")
        rows_by_class[cdir] = rows
    return rows_by_class, n_impl, n_na, problems


def render(rows_by_class, n_impl, n_na) -> str:
    out = [
        "# Tensor Toolbox v3.1 — method-level parity map of tritd_tpu_torch",
        "",
        "Generated by `python -m tritd_tpu_torch.tools.toolbox_audit --out PATH`. One row per",
        "method file of the reference's map (`docs/TOOLBOX_PARITY.md`); every implemented",
        "method has a counterpart in `tritd_tpu_torch/ops/classes.py`.",
        "",
        f"**Summary: {n_impl} methods implemented, {n_na} justified n/a, 0 unmapped.**",
        "",
    ]
    for cdir, rows in rows_by_class.items():
        out += [f"## {cdir}", "", "| method file | counterpart | note |", "|---|---|---|"]
        out += [f"| `{meth}.m` | {target} | {note} |" for meth, target, note in rows]
        out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", action="store_true", help="verify and print the counts (the default)")
    ap.add_argument("--out", default=None, help="also write the port's table to this path")
    args = ap.parse_args(argv)
    rows, n_impl, n_na, problems = audit()
    if problems:
        for p in problems:
            print("PROBLEM:", p)
        return 1
    if args.out:
        Path(args.out).write_text(render(rows, n_impl, n_na))
        print(f"wrote {args.out}")
    print(f"ok ({n_impl} impl, {n_na} n/a)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
