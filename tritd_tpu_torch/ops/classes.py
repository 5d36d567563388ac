"""Tensor Toolbox class surface: thin, immutable wrappers over the functional
Toolbox layer of this package.

PyTorch counterpart of `tritd_tpu/ops/classes.py`: the nine classes of the
Tensor Toolbox v3.1 class library (``@tensor``, ``@sptensor``,
``@ktensor``, ``@ttensor``, ``@tenmat``, ``@sptenmat``, ``@symtensor``,
``@symktensor``, ``@sumtensor``) with the same names, methods, arguments and
results. Each method calls the functions of `ops/{kruskal,decomp,tenutils,
sparse,symmetric}.py` and recomputes none of them.

PyTorch idiom
-------------
* Instances hold `torch.Tensor`s and are immutable: every method returns a
  new object; `with_set` clones, then assigns.
* A constructor given tensors keeps their device (the first tensor's, when
  there are several) and their dtype. Given numpy arrays, lists or numbers,
  it builds on `device`, which defaults to the card: `device=None` raises
  `RuntimeError` without CUDA (`ops/kruskal.py::default_device`), so pass
  `device="cpu"` for the plain PyTorch path. `dtype` casts floating
  inputs. Array operands of a method (factor matrices, vectors, masks) go
  to the device of the tensor they act on; those not yet tensors also take
  its floating dtype.
* `SpTensor` and `SpTenMat` coordinates are int64, as in `ops/sparse.py`;
  coordinates given as numpy arrays are checked on the host
  (`check_coords`), since an out-of-range index is a device-side assert on
  CUDA.
* `find` uses `torch.nonzero`; `__array__` goes through `.cpu().numpy()`.
* The reference registers every class as a JAX pytree so instances flow
  through `jit`/`vmap`/`grad`. Nothing in torch needs that: gradients flow
  through the tensors an instance holds by `torch.autograd`
  (`SymKTensor.fg`, `KTensor.tovec`/`from_vec`), and there is no
  `tree_flatten`/`tree_unflatten`.
* A torch tensor has a `double()` method (a cast to float64), which a JAX
  array has not: where the reference asks `hasattr(x, "double")`, this
  module asks whether `x` is one of the nine classes.
* `Tensor.collapse` takes `torch.sum`, `torch.amax`, ... as `fun`;
  `SpTensor.collapse` stays sparse-native for `fun=torch.sum`.

Where the reference has open faults
-----------------------------------
* `SymTensor.tenfun` (and every elementwise operator, which go through it)
  raises `ValueError` for a dense operand that is not symmetric or not of
  the tensor's shape. The reference marks the result presymmetrized there
  and builds an object that breaks its own invariant; on symmetric operands
  and scalars the two agree.
* `SymKTensor.normalize` never flips a sign; its docstring says so (the
  reference's says odd orders flip and the code does not).
* `SpTensor.__getitem__` calls `int(i)` on scalar subscripts. Under the
  reference's `jit` that fails on traced scalars; eager torch has no such
  case (a 0-d tensor is read on the host).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from . import sparse as _sp
from . import symmetric as _sym
from . import tenutils as _tu
from .decomp import mttkrp as _dense_mttkrp
from .kruskal import cp_normalize, default_device, ktensor_full
from .kruskal import tenmat as _tenmat_fn

__all__ = [
    "Tensor",
    "SpTensor",
    "KTensor",
    "TTensor",
    "SymTensor",
    "SymKTensor",
    "SumTensor",
    "TenMat",
    "SpTenMat",
]

#: a dense operand of `SymTensor.tenfun` counts as symmetric when no
#: permutation moves an entry by more than this many ulps of its largest
_SYMMETRY_ULPS = 64


def _data_of(other):
    """Unwrap a Tensor operand to its tensor (anything else passes through)."""
    if isinstance(other, Tensor):
        return other.data
    return other


def _as_tensor(a, device, dtype) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _placed(arrays, device=None, dtype=None) -> list:
    """`arrays` as tensors on one device: `device` when given, else the
    device of the first tensor among them, else the card."""
    if device is None:
        device = next((a.device for a in arrays if isinstance(a, torch.Tensor)), None)
    dev = default_device(device)
    return [_as_tensor(a, dev, dtype) for a in arrays]


def _operand(x, like: torch.Tensor):
    """An operand of `like`: a tensor or a number as it is, anything else
    (numpy array, list) as `_on` makes it."""
    if isinstance(x, (torch.Tensor, int, float, complex, bool, np.generic)):
        return x
    return _on(x, like)


def _on(x, like: torch.Tensor) -> torch.Tensor:
    """An array operand (factor, vector, mask) as a tensor on `like`'s
    device; one that is not a tensor yet takes `like`'s floating dtype."""
    if isinstance(x, torch.Tensor):
        return x
    t = torch.as_tensor(np.asarray(x), device=like.device)
    if t.is_floating_point() and like.is_floating_point():
        t = t.to(like.dtype)
    return t


def _is_class(x) -> bool:
    return isinstance(x, (Tensor, SpTensor, KTensor, TTensor, SymTensor, SymKTensor, SumTensor,
                          TenMat, SpTenMat))


def _dense(x, like: torch.Tensor):
    """A class operand densified (`double()`), any other as `_operand`."""
    return x.double() if _is_class(x) else _operand(x, like)


def _shape_of(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(np.shape(x))


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.reshape(-1), b.reshape(-1)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.vdot(a.to(dt), b.to(dt))


def _with_modes(items, modes, single_ndim: int):
    """(list of operands, list of modes): one operand of `single_ndim`
    dimensions with one mode (default 0), or a sequence with its modes
    (default the first len(items))."""
    if getattr(items, "ndim", None) == single_ndim:
        return [items], [0 if modes is None else int(modes)]
    items = list(items)
    return items, (list(range(len(items))) if modes is None else [int(m) for m in modes])


def _false(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(False, device=like.device)


def _flat_at_nonzeros(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x's entries at the nonzeros of w, in row-major order."""
    return x.reshape(-1)[torch.nonzero(w.reshape(-1)).squeeze(1)]


class Tensor:
    """Dense tensor — ``@tensor``. Wraps one `torch.Tensor`.

    Methods mirror the ``@tensor`` method files: ``norm.m``, ``innerprod.m``,
    ``ttm.m``, ``ttv.m``, ``ttt.m``, ``ttsv.m``, ``mttkrp.m``, ``nvecs.m``,
    ``collapse.m``, ``contract.m``, ``scale.m``, ``squeeze.m``,
    ``permute.m``, ``reshape.m``, ``symmetrize.m``, ``issymmetric.m``,
    ``tenfun.m``, ``full.m``, ``double.m``, plus the arithmetic /
    comparison / logical operator files.
    """

    def __init__(self, data, device=None, dtype=None):
        (self.data,) = _placed([_data_of(data)], device, dtype)

    # -- shape surface (`ndims.m`, `size.m`, `nnz.m`, `isscalar.m`)
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    def nnz(self):
        return torch.sum(self.data != 0)

    def isscalar(self) -> bool:
        return self.data.ndim == 0

    # -- conversions (`full.m`, `double.m`)
    def full(self) -> "Tensor":
        return self

    def double(self) -> torch.Tensor:
        """The data (``double.m``); not a cast, unlike `torch.Tensor.double`."""
        return self.data

    def __array__(self, dtype=None, copy=None):
        a = self.data.detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    def _op(self, other):
        return _operand(_data_of(other), self.data)

    # -- arithmetic (`plus/minus/times/rdivide/ldivide/power/uminus.m`)
    def __add__(self, other):
        return Tensor(self.data + self._op(other))

    __radd__ = __add__

    def __sub__(self, other):
        return Tensor(self.data - self._op(other))

    def __rsub__(self, other):
        return Tensor(self._op(other) - self.data)

    def __mul__(self, other):
        return Tensor(self.data * self._op(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return Tensor(self.data / self._op(other))

    def __rtruediv__(self, other):
        return Tensor(self._op(other) / self.data)

    def __pow__(self, other):
        return Tensor(self.data ** self._op(other))

    def __neg__(self):
        return Tensor(-self.data)

    def __pos__(self):
        return self

    def __abs__(self):
        return Tensor(torch.abs(self.data))

    def exp(self):
        return Tensor(torch.exp(self.data))

    # -- comparisons / logicals (`eq/ne/lt/le/gt/ge/and/or/not/xor.m`)
    def __eq__(self, other):
        return Tensor(self.data == self._op(other))

    def __ne__(self, other):
        return Tensor(self.data != self._op(other))

    def __lt__(self, other):
        return Tensor(self.data < self._op(other))

    def __le__(self, other):
        return Tensor(self.data <= self._op(other))

    def __gt__(self, other):
        return Tensor(self.data > self._op(other))

    def __ge__(self, other):
        return Tensor(self.data >= self._op(other))

    __hash__ = None  # like torch.Tensor: == is elementwise

    def logical_and(self, other):
        return Tensor((self.data != 0) & (self._op(other) != 0))

    def logical_or(self, other):
        return Tensor((self.data != 0) | (self._op(other) != 0))

    def logical_not(self):
        return Tensor(self.data == 0)

    def logical_xor(self, other):
        return Tensor((self.data != 0) ^ (self._op(other) != 0))

    def isequal(self, other) -> torch.Tensor:
        o = self._op(other)
        if _shape_of(o) != self.shape:
            return _false(self.data)
        return torch.all(self.data == o)

    # -- indexing (`subsref.m`; MATLAB's `end` is Python's negative index:
    # X(end,:,:) is X[-1])
    def __getitem__(self, idx):
        return Tensor(self.data[idx])

    def find(self):
        """(subs, vals) of the nonzero entries — ``@tensor/find.m``: an
        (nnz, ndim) 0-based int64 subscript tensor (`torch.nonzero`, row-major
        order) and the matching values. The count is read on the host."""
        subs = torch.nonzero(self.data)
        return subs, self.data[tuple(subs.unbind(1))]

    # -- scalar division forms (`@tensor/mldivide.m`, `mrdivide.m`)
    def mldivide(self, scalar):
        """scalar \\ X — every element divided by `scalar`."""
        return Tensor(self.data / scalar)

    def mrdivide(self, scalar):
        """X / scalar — alias of __truediv__ for scalar operands."""
        return Tensor(self.data / scalar)

    # -- structure ops (`permute/reshape/squeeze.m`)
    def permute(self, order) -> "Tensor":
        return Tensor(self.data.permute(tuple(order)))

    def reshape(self, shape) -> "Tensor":
        return Tensor(self.data.reshape(tuple(shape)))

    def squeeze(self) -> "Tensor":
        return Tensor(torch.squeeze(self.data))

    # -- numerics
    def norm(self) -> torch.Tensor:
        """Frobenius norm — ``@tensor/norm.m``."""
        return torch.linalg.vector_norm(self.data.reshape(-1))

    def innerprod(self, other) -> torch.Tensor:
        """<X, Y> — ``@tensor/innerprod.m``; a decomposed or sparse operand
        computes it by its own method, as the toolbox dispatches."""
        if isinstance(other, (KTensor, TTensor, SpTensor, SumTensor)):
            return other.innerprod(self)
        return _vdot(self.data, self._op(other))

    def ttm(self, mats, modes=None, transpose: bool = False) -> "Tensor":
        """Tensor-times-matrix — ``@tensor/ttm.m`` (one matrix or a list)."""
        mats, modes = _with_modes(mats, modes, 2)
        out = self.data
        for m, u in zip(modes, mats):
            out = _tu.ttm(out, _on(u, out), m, transpose=transpose)
        return Tensor(out)

    def ttv(self, vecs, modes=None) -> "Tensor":
        if getattr(vecs, "ndim", None) == 1:
            vecs = _on(vecs, self.data)
        else:
            vecs = [_on(v, self.data) for v in vecs]
        return Tensor(_tu.ttv(self.data, vecs, modes))

    def ttt(self, other, adims=None, bdims=None) -> "Tensor":
        return Tensor(_tu.ttt(self.data, _on(_data_of(other), self.data), adims, bdims))

    def ttsv(self, x, keep: int = 1):
        return _sym.ttsv(self.data, _on(x, self.data), keep)

    def mttkrp(self, factors, mode: int) -> torch.Tensor:
        return _dense_mttkrp(self.data, [_on(u, self.data) for u in factors], mode)

    def mttkrps(self, factors) -> list:
        """All-modes MTTKRP sequence — ``@tensor/mttkrps.m``: the N
        single-mode calls (the toolbox splits the modes to share partial
        Khatri-Rao products; `mttkrp` here never forms one)."""
        us = [_on(u, self.data) for u in factors]
        return [_dense_mttkrp(self.data, us, n) for n in range(self.ndim)]

    def nvecs(self, mode: int, r: int) -> torch.Tensor:
        return _tu.nvecs(self.data, mode, r)

    def with_set(self, idx, value) -> "Tensor":
        """Functional subscripted assignment — ``@tensor/subsasgn.m``
        (X(idx) = v): a clone with the entries replaced."""
        out = self.data.clone()
        out[idx] = self._op(value)
        return Tensor(out)

    def collapse(self, dims=None, fun=torch.sum):
        out = _tu.collapse(self.data, dims, fun)
        return out if out.ndim == 0 else Tensor(out)

    def contract(self, i: int, j: int):
        out = _tu.contract(self.data, i, j)
        return out if out.ndim == 0 else Tensor(out)

    def scale(self, s, dims) -> "Tensor":
        return Tensor(_tu.scale(self.data, self._op(s), dims))

    def symmetrize(self) -> "Tensor":
        return Tensor(_sym.symmetrize(self.data))

    def issymmetric(self, tol: float = 1e-6):
        return _sym.is_symmetric(self.data, tol)

    def tenfun(self, fn, *others) -> "Tensor":
        """Apply an elementwise function across tensors — ``tenfun.m``."""
        return Tensor(fn(self.data, *[self._op(o) for o in others]))

    def mask(self, w) -> torch.Tensor:
        """Values at the nonzeros of mask W — ``mask.m``."""
        return _flat_at_nonzeros(self.data, self._op(w))

    def to_tenmat(self, row_modes, col_modes=None) -> "TenMat":
        return TenMat.from_tensor(self.data, row_modes, col_modes)

    def __repr__(self):
        return f"Tensor(shape={self.shape}, dtype={self.data.dtype}, device={self.data.device})"


class SpTensor:
    """Sparse COO tensor — ``@sptensor``; wraps the functional triple of
    :mod:`tritd_tpu_torch.ops.sparse` (``vals, coords, shape``), coordinates
    int64. Duplicate coordinates accumulate, as ``sptensor.m`` documents."""

    def __init__(self, vals, coords, shape, device=None, dtype=None):
        shape = tuple(int(s) for s in shape)
        if not isinstance(coords, torch.Tensor):
            _sp.check_coords(coords, shape)
        self.vals, coords = _placed([vals, coords], device, dtype)
        self.coords = coords.to(torch.int64)
        self.shape = shape

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def nnz(self):
        return self.vals.shape[0]

    def _at(self):
        """The stored coordinates as an index tuple."""
        return tuple(self.coords.unbind(1))

    def _new(self, vals) -> "SpTensor":
        return SpTensor(vals, self.coords, self.shape)

    # -- conversions (`full.m`, `double.m`)
    def full(self) -> Tensor:
        return Tensor(_sp.sp_full(self.vals, self.coords, self.shape))

    def double(self) -> torch.Tensor:
        return self.full().data

    # -- arithmetic: value maps that fix 0 stay sparse (`times`-style);
    #    sptensor +- sptensor concatenates (duplicates accumulate).
    def __mul__(self, other):
        if isinstance(other, SpTensor):
            # elementwise product: gather other's dense values at our coords
            return self._new(self.vals * other.double()[self._at()])
        if isinstance(other, Tensor) or getattr(other, "ndim", 0) > 0:
            return self._new(self.vals * _on(_data_of(other), self.vals)[self._at()])
        return self._new(self.vals * other)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        return self._new(self.vals / scalar)

    def __neg__(self):
        return self._new(-self.vals)

    def __abs__(self):
        return self._new(torch.abs(self.vals))

    def __add__(self, other):
        if isinstance(other, SpTensor):
            if other.shape != self.shape:
                raise ValueError("shape mismatch")
            return SpTensor(torch.cat([self.vals, other.vals]), torch.cat([self.coords, other.coords]),
                            self.shape)
        return Tensor(self.double() + _operand(_data_of(other), self.vals))

    def __sub__(self, other):
        if isinstance(other, SpTensor):
            return self + (-other)
        return Tensor(self.double() - _operand(_data_of(other), self.vals))

    def __pos__(self):
        return self

    # -- scalar division forms (`@sptensor/mldivide.m`, `mrdivide.m`)
    def mldivide(self, scalar):
        """scalar \\ X — ``@sptensor/mldivide.m`` (scalar left-divide)."""
        return self._new(self.vals / scalar)

    def mrdivide(self, scalar):
        """X / scalar — ``@sptensor/mrdivide.m``."""
        return self._new(self.vals / scalar)

    # -- predicates (`isscalar.m` is always false for sptensor; `isequal.m`)
    def isscalar(self) -> bool:
        return False

    def isequal(self, other) -> torch.Tensor:
        oshape = other.shape if hasattr(other, "shape") else np.shape(other)
        if tuple(oshape) != self.shape:
            return _false(self.vals)
        return torch.all(self.double() == _dense(other, self.vals))

    # -- comparisons / logicals (`@sptensor/{eq,ne,lt,le,gt,ge,and,or,not,
    # xor}.m`). The toolbox returns an sptensor over the true pattern; here,
    # as in the reference, the dense boolean Tensor (equal after `double`).
    def _cmp(self, other, op):
        return Tensor(op(self.double(), _dense(other, self.vals)))

    def __eq__(self, other):
        return self._cmp(other, lambda a, b: a == b)

    def __ne__(self, other):
        return self._cmp(other, lambda a, b: a != b)

    def __lt__(self, other):
        return self._cmp(other, lambda a, b: a < b)

    def __le__(self, other):
        return self._cmp(other, lambda a, b: a <= b)

    def __gt__(self, other):
        return self._cmp(other, lambda a, b: a > b)

    def __ge__(self, other):
        return self._cmp(other, lambda a, b: a >= b)

    __hash__ = None  # == is elementwise

    def logical_and(self, other):
        return self._cmp(other, lambda a, b: (a != 0) & (b != 0))

    def logical_or(self, other):
        return self._cmp(other, lambda a, b: (a != 0) | (b != 0))

    def logical_xor(self, other):
        return self._cmp(other, lambda a, b: (a != 0) ^ (b != 0))

    def logical_not(self):
        return Tensor(self.double() == 0)

    # -- indexing (`@sptensor/subsref.m`; MATLAB `end` = negative index)
    def __getitem__(self, idx):
        """A full subscript of ints (or 0-d tensors, read on the host) is a
        sparse-native lookup: the sum of the stored values there. Any other
        index densifies."""
        if (
            isinstance(idx, tuple)
            and len(idx) == self.ndim
            and all(isinstance(i, int) or getattr(i, "ndim", 1) == 0 for i in idx)
        ):
            want = torch.tensor([int(i) % self.shape[k] for k, i in enumerate(idx)],
                                dtype=torch.int64, device=self.coords.device)
            match = torch.all(self.coords == want[None, :], dim=1)
            return torch.where(match, self.vals, torch.zeros_like(self.vals)).sum()
        return Tensor(self.double()[idx])

    def with_set(self, subs, vals) -> "SpTensor":
        """Functional subscripted assignment — ``@sptensor/subsasgn.m``:
        replaces (does not accumulate) the entries at `subs`; nnz changes."""
        subs = subs.detach().cpu().numpy() if isinstance(subs, torch.Tensor) else np.asarray(subs)
        subs = np.atleast_2d(subs)
        _sp.check_coords(subs, self.shape)
        new_c = torch.as_tensor(subs, dtype=torch.int64, device=self.coords.device)
        new_v = torch.atleast_1d(torch.as_tensor(vals, dtype=self.vals.dtype, device=self.vals.device))
        lin_old = _sp.sp_sub2ind(self.coords, self.shape)
        lin_new = _sp.sp_sub2ind(new_c, self.shape)
        keep = ~torch.isin(lin_old, lin_new)
        return SpTensor(torch.cat([self.vals[keep], new_v]), torch.cat([self.coords[keep], new_c]),
                        self.shape)

    def elemwise(self, fn) -> "SpTensor":
        v, c, s = _sp.sp_elemwise(self.vals, self.coords, self.shape, fn)
        return SpTensor(v, c, s)

    # `@sptensor/elemfun.m` is the toolbox name for the same operation.
    elemfun = elemwise

    def find(self):
        """(subs, vals) of stored entries — ``@sptensor/find.m``."""
        return self.coords, self.vals

    def coalesce(self) -> "SpTensor":
        """Merge duplicate coordinates (sorted by linear index; nnz changes)."""
        lin = _sp.sp_sub2ind(self.coords, self.shape)
        uniq, inv = torch.unique(lin, sorted=True, return_inverse=True)
        vals = torch.zeros(uniq.shape[0], dtype=self.vals.dtype, device=self.vals.device)
        vals.index_add_(0, inv, self.vals)
        return SpTensor(vals, _sp.sp_ind2sub(uniq, self.shape), self.shape)

    # -- numerics
    def norm(self) -> torch.Tensor:
        return _sp.sp_norm(self.vals, self.coords, self.shape)

    def innerprod(self, other) -> torch.Tensor:
        if isinstance(other, SpTensor):
            other = other.full()
        return _sp.sp_innerprod(self.vals, self.coords, self.shape, _on(_data_of(other), self.vals))

    def ttv(self, vecs, modes=None) -> Tensor:
        vecs, modes = _with_modes(vecs, modes, 1)
        out = _sp.sp_ttv(self.vals, self.coords, self.shape, [_on(v, self.vals) for v in vecs], modes)
        return Tensor(out)

    def mttkrp(self, factors, mode: int) -> torch.Tensor:
        return _sp.sp_mttkrp(self.vals, self.coords, self.shape, [_on(u, self.vals) for u in factors],
                             mode)

    def _keep_scatter(self, keep, vals):
        """Scatter `vals` (one per stored entry) onto the kept modes (sum)."""
        if not keep:
            return torch.sum(vals)
        kshape = tuple(self.shape[i] for i in keep)
        lin = _sp.sp_sub2ind(self.coords[:, list(keep)], kshape)
        out = torch.zeros((math.prod(kshape),), dtype=vals.dtype, device=vals.device)
        return Tensor(out.index_add_(0, lin, vals).reshape(kshape))

    def collapse(self, dims=None, fun=torch.sum):
        """``@sptensor/collapse.m``. The sum stays sparse-native (one
        scatter-add of stored values onto the kept modes); any other
        reducer densifies, since implicit zeros take part in it."""
        n = self.ndim
        if dims is None:
            dims = tuple(range(n))
        dims = (dims,) if isinstance(dims, int) else dims
        dims = tuple(int(d) % n for d in dims)
        keep = tuple(i for i in range(n) if i not in dims)
        if fun is torch.sum:
            return self._keep_scatter(keep, self.vals)
        out = _tu.collapse(self.double(), dims, fun)
        return out if out.ndim == 0 else Tensor(out)

    def contract(self, i: int, j: int):
        """Diagonal contraction over equal-sized modes i, j —
        ``@sptensor/contract.m``: off-diagonal entries mask to zero, the
        rest scatter onto the remaining modes."""
        if self.shape[i] != self.shape[j]:
            raise ValueError("contracted modes must have equal size")
        keep = tuple(k for k in range(self.ndim) if k not in (int(i), int(j)))
        ondiag = self.coords[:, i] == self.coords[:, j]
        return self._keep_scatter(keep, torch.where(ondiag, self.vals, torch.zeros_like(self.vals)))

    def divide(self, k: "KTensor", epsilon: float = 1e-10) -> "SpTensor":
        """Divide by a nonnegative ktensor at the stored nonzeros only —
        ``@sptensor/divide.m:23-35`` (the cp_apr helper): the dense ktensor
        never forms; the denominator is floored at `epsilon`."""
        entries = k.entries_at(self.coords)
        return self._new(self.vals / torch.clamp(entries, min=epsilon))

    def mask(self, w) -> torch.Tensor:
        """Values of X at the nonzero locations of mask W —
        ``@sptensor/mask.m`` (an sptensor mask keeps its stored order)."""
        if isinstance(w, SpTensor):
            return self.double()[w._at()]
        return _flat_at_nonzeros(self.double(), _on(_data_of(w), self.vals))

    def nvecs(self, mode: int, r: int) -> torch.Tensor:
        """Leading mode-n vectors — ``@sptensor/nvecs.m``: the Gram is dense
        either way, so the dense unfolding is assembled with one scatter
        and the dense eigh path is reused."""
        return _tu.nvecs(self.double(), mode, r)

    def ones(self) -> "SpTensor":
        """Every stored value replaced by 1 — ``@sptensor/ones.m``."""
        return self._new(torch.ones_like(self.vals))

    spones = ones

    def reshape(self, new_shape) -> "SpTensor":
        """``@sptensor/reshape.m``: coordinates remapped through the linear
        index (row-major here, column-major in the toolbox: a relabelling
        that round-trips identically)."""
        new_shape = tuple(int(s) for s in new_shape)
        if math.prod(new_shape) != math.prod(self.shape):
            raise ValueError("reshape must preserve the element count")
        lin = _sp.sp_sub2ind(self.coords, self.shape)
        return SpTensor(self.vals, _sp.sp_ind2sub(lin, new_shape), new_shape)

    def scale(self, s, dims) -> "SpTensor":
        """Scale along modes `dims` by the dense array S —
        ``@sptensor/scale.m`` (S gathered at the stored coordinates)."""
        n = self.ndim
        if isinstance(dims, int):
            dims = (dims,)
        dims = tuple(int(d) % n for d in dims)
        sd = _on(_data_of(s), self.vals).reshape(tuple(self.shape[d] for d in dims))
        return self._new(self.vals * sd[tuple(self.coords[:, d] for d in dims)])

    def spmatrix(self) -> torch.Tensor:
        """2-way sparse → matrix — ``@sptensor/spmatrix.m``: the assembled
        dense matrix, as the reference returns."""
        if self.ndim != 2:
            raise ValueError("spmatrix requires a 2-way sptensor")
        return self.double()

    def squeeze(self):
        """Drop singleton modes — ``@sptensor/squeeze.m``."""
        keep = tuple(i for i, s in enumerate(self.shape) if s != 1)
        if not keep:
            return torch.sum(self.vals)
        if len(keep) == self.ndim:
            return self
        return SpTensor(self.vals, self.coords[:, list(keep)], tuple(self.shape[i] for i in keep))

    def _ttm_single(self, u, mode: int, transpose: bool) -> torch.Tensor:
        """One sparse tensor-times-matrix: each stored value times the
        matrix column lands in the output's mode-`mode` fiber — one
        (prod(other modes), p) `index_add_`, then movedim (the accumarray
        strategy of ``@sptensor/ttm.m``)."""
        u = _on(u, self.vals)
        u = u.T if transpose else u
        p = u.shape[0]
        keep = tuple(i for i in range(self.ndim) if i != mode)
        kshape = tuple(self.shape[i] for i in keep)
        lin = (_sp.sp_sub2ind(self.coords[:, list(keep)], kshape) if keep
               else torch.zeros((self.nnz,), dtype=torch.int64, device=self.coords.device))
        contrib = u[:, self.coords[:, mode]] * self.vals[None, :]  # (p, nnz)
        flat = torch.zeros((math.prod(kshape) if keep else 1, p), dtype=contrib.dtype, device=contrib.device)
        flat.index_add_(0, lin, contrib.T)
        return flat.reshape(kshape + (p,)).movedim(-1, mode)

    def ttm(self, mats, modes=None, transpose: bool = False) -> Tensor:
        """Tensor-times-matrix — ``@sptensor/ttm.m``: the first product is
        the sparse scatter-GEMM; its fibers fill in, so later modes use the
        dense product."""
        mats, modes = _with_modes(mats, modes, 2)
        dense = None
        for m, u in zip(modes, mats):
            if dense is None:
                dense = self._ttm_single(u, m, transpose)
            else:
                dense = _tu.ttm(dense, _on(u, dense), m, transpose=transpose)
        return Tensor(dense)

    def ttt(self, other, adims=None, bdims=None):
        """Tensor-times-tensor — ``@sptensor/ttt.m``. The outer product of
        two sparse tensors stays sparse (coordinate cross-join, value outer
        product); contractions go through the dense unfoldings."""
        if adims is None and bdims is None and isinstance(other, SpTensor):
            na, nb = self.nnz, other.nnz
            vals = (self.vals[:, None] * other.vals[None, :]).reshape(-1)
            ca = self.coords.repeat_interleave(nb, dim=0)
            cb = other.coords.repeat(na, 1)
            return SpTensor(vals, torch.cat([ca, cb], dim=1), self.shape + other.shape)
        return Tensor(_tu.ttt(self.double(), _on(_dense(other, self.vals), self.vals), adims, bdims))

    def permute(self, order) -> "SpTensor":
        order = tuple(order)
        return SpTensor(self.vals, self.coords[:, list(order)], tuple(self.shape[m] for m in order))

    def to_sptenmat(self, row_modes, col_modes=None) -> "SpTenMat":
        vals, (ri, ci), _ = _sp.sptenmat(self.vals, self.coords, self.shape, row_modes, col_modes)
        row_modes = tuple(int(m) for m in row_modes)
        if col_modes is None:
            col_modes = tuple(m for m in range(self.ndim) if m not in row_modes)
        return SpTenMat(vals, ri, ci, row_modes, tuple(col_modes), self.shape)

    def __repr__(self):
        return f"SpTensor(shape={self.shape}, nnz={self.nnz}, device={self.vals.device})"


class KTensor:
    """Kruskal tensor — ``@ktensor``: ``(weights λ, factors U_1..U_N)``."""

    def __init__(self, factors, weights=None, device=None, dtype=None):
        factors = list(factors)
        placed = _placed(factors + ([] if weights is None else [weights]), device, dtype)
        self.factors = placed[: len(factors)]
        u0 = self.factors[0]
        self.weights = (torch.ones((u0.shape[1],), dtype=u0.dtype, device=u0.device)
                        if weights is None else placed[-1])

    @property
    def shape(self):
        return tuple(u.shape[0] for u in self.factors)

    @property
    def ndim(self):
        return len(self.factors)

    def ncomponents(self) -> int:
        """``ncomponents.m``."""
        return self.factors[0].shape[1]

    # -- conversions
    def full(self) -> Tensor:
        return Tensor(ktensor_full(self.factors, self.weights))

    def double(self) -> torch.Tensor:
        return self.full().data

    def tovec(self, lambdaflag: bool = True) -> torch.Tensor:
        """Factors stacked into one vector, column-major per factor —
        ``tovec.m``; differentiable."""
        parts = [u.T.reshape(-1) for u in self.factors]
        if lambdaflag:
            parts = [self.weights] + parts
        return torch.cat(parts)

    @classmethod
    def from_vec(cls, x, shape, rank: int, lambdaflag: bool = True, device=None):
        """Inverse of :meth:`tovec` (``ktensor.m`` 'fromvector'); the
        factors are views of `x`, so gradients flow back to it."""
        (x,) = _placed([x], device)
        off = 0
        weights = None
        if lambdaflag:
            weights, off = x[:rank], rank
        factors = []
        for s in shape:
            factors.append(x[off: off + s * rank].reshape(rank, s).T)
            off += s * rank
        return cls(factors, weights)

    # -- arithmetic (`plus/minus/mtimes/uminus.m`)
    def __add__(self, other):
        if not isinstance(other, KTensor):
            return Tensor(self.double() + _operand(_data_of(other), self.weights))
        return KTensor([torch.cat([u, v], dim=1) for u, v in zip(self.factors, other.factors)],
                       torch.cat([self.weights, other.weights]))

    def __sub__(self, other):
        if isinstance(other, KTensor):
            return self + (-other)
        return Tensor(self.double() - _operand(_data_of(other), self.weights))

    def __neg__(self) -> "KTensor":
        return KTensor(self.factors, -self.weights)

    def __mul__(self, scalar) -> "KTensor":
        return KTensor(self.factors, self.weights * scalar)

    __rmul__ = __mul__

    # -- numerics
    def norm(self) -> torch.Tensor:
        return _tu.ktensor_norm(self.weights, self.factors)

    def innerprod(self, other) -> torch.Tensor:
        if isinstance(other, KTensor):
            return _tu.ktensor_innerprod(self.weights, self.factors, (other.weights, other.factors))
        return _tu.ktensor_innerprod(self.weights, self.factors, _on(_data_of(other), self.weights))

    def mttkrp(self, factors, mode: int) -> torch.Tensor:
        """``@ktensor/mttkrp.m``: V = U_n diag(λ) ∏_{i≠n} (U_iᵀ V_i), the
        dense tensor never forms."""
        vs = [_on(v, self.weights) for v in factors]
        w = self.weights[:, None] * torch.ones((1, vs[0].shape[1]), dtype=self.weights.dtype,
                                               device=self.weights.device)
        for i, v in enumerate(vs):
            if i == mode:
                continue
            w = w * (self.factors[i].T @ v)
        return self.factors[mode] @ w

    def normalize(self) -> "KTensor":
        factors, weights = cp_normalize(self.factors, self.weights)
        return KTensor(factors, weights)

    def arrange(self) -> "KTensor":
        w, f = _tu.ktensor_arrange(self.weights, self.factors)
        return KTensor(f, w)

    def fixsigns(self) -> "KTensor":
        w, f = _tu.ktensor_fixsigns(self.weights, self.factors)
        return KTensor(f, w)

    def redistribute(self, mode: int) -> "KTensor":
        """Absorb λ into factor `mode` — ``redistribute.m``."""
        new = list(self.factors)
        new[mode] = new[mode] * self.weights[None, :]
        return KTensor(new, torch.ones_like(self.weights))

    def score(self, other: "KTensor") -> torch.Tensor:
        return _tu.ktensor_score(self.weights, self.factors, other.weights, other.factors)

    def permute(self, order) -> "KTensor":
        return KTensor([self.factors[m] for m in order], self.weights)

    def ttv(self, vecs, modes=None):
        """``@ktensor/ttv.m``: vectors contract into λ; the remaining modes
        stay Kruskal (a 0-d tensor when every mode is contracted)."""
        vecs, modes = _with_modes(vecs, modes, 1)
        w = self.weights
        for m, v in zip(modes, vecs):
            w = w * (self.factors[m].T @ _on(v, w))
        rest = [u for i, u in enumerate(self.factors) if i not in set(modes)]
        if not rest:
            return torch.sum(w)
        return KTensor(rest, w)

    def __pos__(self):
        return self

    def isscalar(self) -> bool:
        return False

    def isequal(self, other):
        """Same structure, same λ, same factors — ``@ktensor/isequal.m``
        (structural: two Kruskal forms of one dense tensor differ)."""
        if not isinstance(other, KTensor) or self.shape != other.shape:
            return False
        if self.ncomponents() != other.ncomponents():
            return False
        same = torch.all(self.weights == other.weights)
        for u, v in zip(self.factors, other.factors):
            same = same & torch.all(u == v)
        return same

    def issymmetric(self) -> torch.Tensor:
        """All factor matrices identical — ``@ktensor/issymmetric.m``."""
        if len(set(tuple(u.shape) for u in self.factors)) != 1:
            return _false(self.weights)
        u0 = self.factors[0]
        same = torch.tensor(True, device=u0.device)
        for u in self.factors[1:]:
            same = same & torch.all(u == u0)
        return same

    def symmetrize(self) -> "KTensor":
        """Symmetric ktensor whose every factor is the average of the
        normalized, sign-aligned factors — ``@ktensor/symmetrize.m:23-52``:
        |λ| is spread evenly first, and the signs are aligned to the first
        factor so the average does not cancel. The sign of λ stays in λ: an
        even-order negative component has no equal-real-factor form with a
        positive weight."""
        if any(u.shape[0] != self.factors[0].shape[0] for u in self.factors):
            raise ValueError("only cubic ktensors can be symmetrized")
        n = self.ndim
        w_root = torch.abs(self.weights) ** (1.0 / n)
        factors = [u * w_root[None, :] for u in self.factors]
        u1 = factors[0]
        avg = u1
        for u in factors[1:]:
            sgn = torch.sign(torch.sum(u * u1, dim=0))
            sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
            avg = avg + u * sgn[None, :]
        avg = avg / n
        one = torch.ones_like(self.weights, dtype=avg.dtype)
        return KTensor([avg] * n, torch.where(self.weights < 0, -one, one))

    def extract(self, idx) -> "KTensor":
        """Sub-ktensor of the selected components — ``@ktensor/extract.m``."""
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.weights.device)
        return KTensor([u[:, idx] for u in self.factors], self.weights[idx])

    def tocell(self) -> list:
        """Factor matrices as a list — ``@ktensor/tocell.m``."""
        return list(self.factors)

    def entries_at(self, coords: torch.Tensor) -> torch.Tensor:
        """Values at an (m, ndim) coordinate list without densifying:
        Σ_r λ_r ∏_n U_n[i_n, r]. Backs ``@ktensor/mask.m`` and
        ``@sptensor/divide.m``."""
        coords = _on(coords, self.weights)
        prod = self.weights[None, :] * torch.ones((coords.shape[0], 1), dtype=self.weights.dtype,
                                                  device=self.weights.device)
        for n, u in enumerate(self.factors):
            prod = prod * u[coords[:, n], :]
        return torch.sum(prod, dim=1)

    def mask(self, w) -> torch.Tensor:
        """Values at the nonzeros of mask W — ``@ktensor/mask.m`` (never
        densifies for a sparse W)."""
        if isinstance(w, SpTensor):
            return self.entries_at(w.coords)
        return _flat_at_nonzeros(self.double(), _on(_data_of(w), self.weights))

    def nvecs(self, mode: int, r: int, flipsign: bool = True) -> torch.Tensor:
        """Leading mode-n vectors — ``@ktensor/nvecs.m:44-56``: eigh of
        Xn·Xnᵀ = U_n Λ (⊛_{i≠n} U_iᵀU_i) Λ U_nᵀ from the small r×r Grams."""
        k = self.ncomponents()
        g = torch.ones((k, k), dtype=self.factors[0].dtype, device=self.factors[0].device)
        for i, u in enumerate(self.factors):
            if i != mode:
                g = g * (u.T @ u)
        un = self.factors[mode] * self.weights[None, :]
        v = torch.linalg.eigh(un @ g @ un.T)[1].flip(1)[:, :r]
        if flipsign:
            v = v * _tu._positive_peak(v)[None, :]
        return v

    def times(self, other):
        """Elementwise product — ``@ktensor/times.m``: against an sptensor
        only its stored entries are touched (result sparse), against a dense
        operand the result is dense."""
        if isinstance(other, SpTensor):
            return SpTensor(other.vals * self.entries_at(other.coords), other.coords, other.shape)
        return Tensor(self.double() * _dense(other, self.weights))

    def ttm(self, mats, modes=None, transpose: bool = False) -> "KTensor":
        """Tensor-times-matrix — ``@ktensor/ttm.m``: V applied to the
        factor of each mode (V·U_n), staying Kruskal."""
        mats, modes = _with_modes(mats, modes, 2)
        new = list(self.factors)
        for m, v in zip(modes, mats):
            v = _on(v, self.weights)
            new[m] = (v.T if transpose else v) @ new[m]
        return KTensor(new, self.weights)

    def update(self, modes, data) -> "KTensor":
        """Replace λ (toolbox mode 0, here -1) and/or whole factors from one
        stacked vector — ``@ktensor/update.m:33-60``, the vector-of-unknowns
        interface of the optimization methods, in the layout of `tovec`."""
        data = _on(data, self.weights)
        if isinstance(modes, int):
            modes = [modes]
        r = self.ncomponents()
        weights = self.weights
        new = list(self.factors)
        off = 0
        for m in modes:
            if m == -1:
                weights = data[off: off + r]
                off += r
            else:
                sz = self.shape[m]
                new[m] = data[off: off + sz * r].reshape(r, sz).T
                off += sz * r
        return KTensor(new, weights)

    def __repr__(self):
        return f"KTensor(shape={self.shape}, rank={self.ncomponents()}, device={self.weights.device})"


class TTensor:
    """Tucker tensor — ``@ttensor``: ``(core G, factors U_1..U_N)``."""

    def __init__(self, core, factors, device=None, dtype=None):
        placed = _placed([_data_of(core)] + list(factors), device, dtype)
        self.core, self.factors = placed[0], placed[1:]

    @property
    def shape(self):
        return tuple(u.shape[0] for u in self.factors)

    @property
    def ndim(self):
        return len(self.factors)

    def full(self) -> Tensor:
        return Tensor(_tu.ttensor_full(self.core, self.factors))

    def double(self) -> torch.Tensor:
        return self.full().data

    def norm(self) -> torch.Tensor:
        return _tu.ttensor_norm(self.core, self.factors)

    def innerprod(self, other) -> torch.Tensor:
        """``@ttensor/innerprod.m``: the factors are pulled onto the dense
        operand (cost Σ r_i · prod n) instead of densifying this one."""
        if isinstance(other, TTensor):
            other = other.full()
        small = Tensor(_on(_data_of(other), self.core)).ttm(self.factors, transpose=True)
        return _vdot(self.core, small.data)

    def ttm(self, mats, modes=None, transpose: bool = False) -> "TTensor":
        """``@ttensor/ttm.m``: V absorbed into the factor of that mode."""
        mats, modes = _with_modes(mats, modes, 2)
        new = list(self.factors)
        for m, v in zip(modes, mats):
            v = _on(v, self.core)
            new[m] = (v.T if transpose else v) @ new[m]
        return TTensor(self.core, new)

    def ttv(self, vecs, modes=None):
        """``@ttensor/ttv.m``: vᵀU_m contracted into the core; the remaining
        modes stay Tucker (a 0-d tensor when every mode is contracted)."""
        vecs, modes = _with_modes(vecs, modes, 1)
        core = self.core
        # highest mode first, so the earlier axes keep their numbers
        for m, v in sorted(zip(modes, vecs), key=lambda p: -p[0]):
            core = torch.tensordot(core, self.factors[m].T @ _on(v, core), dims=([m], [0]))
        rest = [u for i, u in enumerate(self.factors) if i not in set(modes)]
        if not rest:
            return core
        return TTensor(core, rest)

    def mttkrp(self, factors, mode: int) -> torch.Tensor:
        """``@ttensor/mttkrp.m``: Uᵢᵀ Vᵢ folded into the core, the small
        core's MTTKRP, then lifted through U_n."""
        small = [
            torch.eye(self.core.shape[i], dtype=self.core.dtype, device=self.core.device)
            if i == mode else self.factors[i].T @ _on(factors[i], self.core)
            for i in range(self.ndim)
        ]
        return self.factors[mode] @ _dense_mttkrp(self.core, small, mode)

    # -- `uminus/uplus/mtimes.m` (scalar scaling lands on the core)
    def __neg__(self) -> "TTensor":
        return TTensor(-self.core, self.factors)

    def __pos__(self):
        return self

    def __mul__(self, scalar) -> "TTensor":
        return TTensor(self.core * scalar, self.factors)

    __rmul__ = __mul__

    def isscalar(self) -> bool:
        return False

    def isequal(self, other):
        """Structural equality (same core, same factors) —
        ``@ttensor/isequal.m``."""
        if not isinstance(other, TTensor) or self.shape != other.shape:
            return False
        if self.core.shape != other.core.shape:
            return False
        same = torch.all(self.core == other.core)
        for u, v in zip(self.factors, other.factors):
            same = same & torch.all(u == v)
        return same

    def permute(self, order) -> "TTensor":
        """``@ttensor/permute.m``: the core permuted, the factors reordered."""
        order = tuple(int(m) for m in order)
        return TTensor(self.core.permute(order), [self.factors[m] for m in order])

    def nvecs(self, mode: int, r: int, flipsign: bool = True) -> torch.Tensor:
        """Leading mode-n vectors — ``@ttensor/nvecs.m``: the Gram
        Xn·Xnᵀ = U_n [G_(n) (⊗ U_iᵀU_i) G_(n)ᵀ] U_nᵀ through the small core."""
        gcore = self.core
        for i, u in enumerate(self.factors):
            if i != mode:
                gcore = _tu.ttm(gcore, u.T @ u, i)
        cn = self.core.movedim(mode, 0).reshape(self.core.shape[mode], -1)
        gn = gcore.movedim(mode, 0).reshape(gcore.shape[mode], -1)
        un = self.factors[mode]
        v = torch.linalg.eigh(un @ (cn @ gn.T) @ un.T)[1].flip(1)[:, :r]
        if flipsign:
            v = v * _tu._positive_peak(v)[None, :]
        return v

    def __getitem__(self, idx):
        """Single-entry lookup — ``@ttensor/subsref.m``: the factor rows
        contracted into the core (cost ∏rᵢ, never densifies)."""
        if isinstance(idx, tuple) and len(idx) == self.ndim:
            core = self.core
            for m in range(self.ndim - 1, -1, -1):
                row = self.factors[m][int(idx[m]) % self.shape[m], :]
                core = torch.tensordot(core, row, dims=([m], [0]))
            return core
        raise TypeError("TTensor indexing requires a full subscript tuple")

    def __repr__(self):
        return f"TTensor(shape={self.shape}, core={tuple(self.core.shape)}, device={self.core.device})"


class SymTensor:
    """Symmetric tensor — ``@symtensor``. Stores the dense symmetrized array,
    as the reference does (not the distinct-element compression;
    :mod:`tritd_tpu_torch.ops.symmetric`)."""

    def __init__(self, data, presymmetrized: bool = False, device=None, dtype=None):
        (data,) = _placed([_data_of(data)], device, dtype)
        self.data = data if presymmetrized else _sym.symmetrize(data)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    def full(self) -> Tensor:
        return Tensor(self.data)

    def double(self) -> torch.Tensor:
        return self.data

    def issymmetric(self, tol: float = 1e-6):
        return _sym.is_symmetric(self.data, tol)

    def ttsv(self, x, keep: int = 1):
        return _sym.ttsv(self.data, _on(x, self.data), keep)

    def norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.data.reshape(-1))

    def indices(self) -> np.ndarray:
        """Distinct (sorted, non-decreasing) index tuples — the monomial
        list ``@symtensor/indices.m`` enumerates; a symmetric tensor is
        determined by its values there. A host-side numpy array."""
        n, m = (self.shape[0] if self.ndim else 0), self.ndim
        return np.array(list(itertools.combinations_with_replacement(range(n), m)),
                        dtype=np.int64).reshape(-1, m)

    def vals(self) -> torch.Tensor:
        """Values at :meth:`indices` — the distinct-element vector of the
        toolbox's compressed representation."""
        subs = torch.as_tensor(self.indices(), device=self.data.device)
        return self.data[tuple(subs.unbind(1))]

    # -- elementwise surface (`@symtensor/{plus,minus,times,rdivide,ldivide,
    # power,mtimes(scalar),mldivide,mrdivide,uminus,uplus,tenfun}.m` and the
    # comparison/logical files): each goes through `tenfun`, which returns a
    # SymTensor over the mapped data without symmetrizing again.
    def _sym_of(self, other):
        return other.data if isinstance(other, (SymTensor, Tensor)) else _operand(_data_of(other), self.data)

    def _symmetric_operand(self, other):
        """`other` as an operand of an elementwise map whose result stays
        symmetric: a SymTensor, a scalar, or a dense tensor of this shape
        that is symmetric to rounding (`_SYMMETRY_ULPS`)."""
        if isinstance(other, SymTensor):
            return other.data
        o = self._sym_of(other)
        if not isinstance(o, torch.Tensor) or o.ndim == 0:
            return o
        if tuple(o.shape) != self.shape:
            raise ValueError(f"SymTensor.tenfun: a dense operand must have the shape {self.shape}, "
                             f"got {tuple(o.shape)}")
        wide = o if o.is_floating_point() else o.to(torch.float64)
        tol = _SYMMETRY_ULPS * torch.finfo(wide.dtype).eps * float(wide.abs().max()) if wide.numel() else 0.0
        if not bool(_sym.is_symmetric(wide, tol)):
            raise ValueError("SymTensor.tenfun: a dense operand that is not symmetric makes a result that "
                             "is not; symmetrize it first (SymTensor(x))")
        return o

    def tenfun(self, fn, *others) -> "SymTensor":
        """``@symtensor/tenfun.m``: an elementwise `fn` of this tensor and
        `others` (SymTensors, scalars, or symmetric dense tensors of this
        shape; any other operand raises ValueError)."""
        ops = [self._symmetric_operand(o) for o in others]
        return SymTensor(fn(self.data, *ops), presymmetrized=True)

    def __add__(self, other):
        return self.tenfun(lambda a, b: a + b, other)

    __radd__ = __add__

    def __sub__(self, other):
        return self.tenfun(lambda a, b: a - b, other)

    def __rsub__(self, other):
        return self.tenfun(lambda a, b: b - a, other)

    def __mul__(self, other):
        return self.tenfun(lambda a, b: a * b, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.tenfun(lambda a, b: a / b, other)

    def __rtruediv__(self, other):
        return self.tenfun(lambda a, b: b / a, other)

    def __pow__(self, other):
        return self.tenfun(lambda a, b: a ** b, other)

    def __neg__(self):
        return self.tenfun(lambda a: -a)

    def __pos__(self):
        return self

    def mldivide(self, scalar):
        return self.tenfun(lambda a, s: a / s, scalar)

    def mrdivide(self, scalar):
        return self.tenfun(lambda a, s: a / s, scalar)

    def __eq__(self, other):
        return self.tenfun(lambda a, b: a == b, other)

    def __ne__(self, other):
        return self.tenfun(lambda a, b: a != b, other)

    def __lt__(self, other):
        return self.tenfun(lambda a, b: a < b, other)

    def __le__(self, other):
        return self.tenfun(lambda a, b: a <= b, other)

    def __gt__(self, other):
        return self.tenfun(lambda a, b: a > b, other)

    def __ge__(self, other):
        return self.tenfun(lambda a, b: a >= b, other)

    __hash__ = None  # == is elementwise

    def logical_and(self, other):
        return self.tenfun(lambda a, b: (a != 0) & (b != 0), other)

    def logical_or(self, other):
        return self.tenfun(lambda a, b: (a != 0) | (b != 0), other)

    def logical_not(self):
        return self.tenfun(lambda a: a == 0)

    def logical_xor(self, other):
        return self.tenfun(lambda a, b: (a != 0) ^ (b != 0), other)

    def isequal(self, other) -> torch.Tensor:
        od = self._sym_of(other)
        if _shape_of(od) != self.shape:
            return _false(self.data)
        return torch.all(self.data == od)

    def isscalar(self) -> bool:
        return self.data.ndim == 0

    def __getitem__(self, idx):
        """``@symtensor/subsref.m`` — index into the (dense) data."""
        return self.data[idx]

    def with_set(self, idx, value) -> "SymTensor":
        """Functional ``@symtensor/subsasgn.m``: assigning one distinct
        element writes every symmetric copy, so the invariant survives."""
        data = self.data.clone()
        for perm in set(itertools.permutations(tuple(int(i) for i in idx))):
            data[perm] = value
        return SymTensor(data, presymmetrized=True)

    def __repr__(self):
        n = self.shape[0] if self.ndim else 0
        return f"SymTensor(order={self.ndim}, n={n}, device={self.data.device})"


class SymKTensor:
    """Symmetric Kruskal tensor — ``@symktensor``: Σ_r λ_r u_r^{⊗m}."""

    def __init__(self, weights, u, order: int, device=None, dtype=None):
        self.weights, self.u = _placed([weights, u], device, dtype)
        self.order = int(order)

    @property
    def shape(self):
        return (self.u.shape[0],) * self.order

    def full(self) -> SymTensor:
        return SymTensor(_sym.symktensor_full(self.weights, self.u, self.order), presymmetrized=True)

    def double(self) -> torch.Tensor:
        return self.full().data

    def norm(self) -> torch.Tensor:
        g = (self.u.T @ self.u) ** self.order
        q = self.weights @ g @ self.weights
        return torch.sqrt(torch.clamp(q, min=0.0))

    @property
    def ndim(self):
        return self.order

    def ncomponents(self) -> int:
        """``@symktensor/ncomponents.m``."""
        return self.u.shape[1]

    def isscalar(self) -> bool:
        return False

    def issymmetric(self) -> bool:
        """``@symktensor/issymmetric.m`` — true by construction."""
        return True

    def isequal(self, other) -> torch.Tensor:
        if (not isinstance(other, SymKTensor) or other.order != self.order
                or other.u.shape != self.u.shape):
            return _false(self.u)
        return torch.all(self.weights == other.weights) & torch.all(self.u == other.u)

    def __mul__(self, scalar) -> "SymKTensor":
        return SymKTensor(self.weights * scalar, self.u, self.order)

    __rmul__ = __mul__

    def __neg__(self) -> "SymKTensor":
        return SymKTensor(-self.weights, self.u, self.order)

    def __pos__(self):
        return self

    def normalize(self) -> "SymKTensor":
        """Unit-normalize the columns of U, absorbing norm^m per component
        into λ — ``@symktensor/normalize.m``. No sign is flipped, at any
        order: λ keeps its sign and each column its direction."""
        nrm = torch.linalg.vector_norm(self.u, dim=0)
        safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
        return SymKTensor(self.weights * safe ** self.order, self.u / safe[None, :], self.order)

    def arrange(self) -> "SymKTensor":
        """Normalize, then sort components by |λ| descending —
        ``@symktensor/arrange.m``."""
        k = self.normalize()
        order_idx = torch.argsort(-torch.abs(k.weights))
        return SymKTensor(k.weights[order_idx], k.u[:, order_idx], k.order)

    def permute(self, order) -> "SymKTensor":
        """``@symktensor/permute.m`` — any mode permutation of a symmetric
        tensor is itself."""
        if len(tuple(order)) != self.order:
            raise ValueError("permutation length must equal the order")
        return self

    def entry(self, idx) -> torch.Tensor:
        """One entry Σ_r λ_r ∏_j U[i_j, r] — ``@symktensor/entry.m``."""
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.u.device)
        prod = self.weights
        for j in range(self.order):
            prod = prod * self.u[idx[j], :]
        return torch.sum(prod)

    def tovec(self, lambdaflag: bool = True) -> torch.Tensor:
        """[λ; vec(U)] — ``@symktensor/tovec.m``; differentiable."""
        parts = [self.u.T.reshape(-1)]
        if lambdaflag:
            parts = [self.weights] + parts
        return torch.cat(parts)

    @classmethod
    def from_vec(cls, x, n: int, rank: int, order: int, lambdaflag: bool = True, device=None):
        """Inverse of :meth:`tovec` (``symktensor.m`` 'fromvector')."""
        (x,) = _placed([x], device)
        off = rank if lambdaflag else 0
        weights = x[:rank] if lambdaflag else torch.ones((rank,), dtype=x.dtype, device=x.device)
        u = x[off: off + n * rank].reshape(rank, n).T
        return cls(weights, u, order)

    def score(self, other: "SymKTensor") -> torch.Tensor:
        """Similarity score — ``@symktensor/score.m``: the Kruskal score on
        the order-m repeated factors."""
        return _tu.ktensor_score(self.weights, [self.u] * self.order, other.weights,
                                 [other.u] * other.order)

    def fg_setup(self, a) -> dict:
        """Precomputation for :meth:`fg` — ``@symktensor/fg_setup.m`` (fast
        path): ‖A‖², the order m and the symmetric data array."""
        ad = a.data if isinstance(a, (SymTensor, Tensor)) else _on(_data_of(a), self.u)
        flat = ad.reshape(-1)
        return {"a": ad, "m": self.order, "norm_a_sqr": torch.dot(flat, flat)}

    def fg(self, data: dict):
        """Objective ‖A − full(M)‖² and its gradient for the symmetric
        Kruskal model — ``@symktensor/fg.m:60-76`` (fast path):

            F  = ‖A‖² − 2 λ·z + λᵀ (UᵀU)^{∘m} λ,   z_p = A·x_p^m
            Gλ = −2 z + 2 (UᵀU)^{∘m} λ
            GU = −2m·Y·diag(λ) + 2m·U·diag(λ)(UᵀU)^{∘(m−1)}diag(λ)

        with Y[:,p] = ttsv(A, x_p) = A x_p^{m−1} (`torch.func.vmap` over the
        components). Returns ``(f, g)``, g = [Gλ; vec(GU)] in the layout of
        :meth:`tovec`; both are differentiable by `torch.autograd`."""
        a, m = data["a"], data["m"]
        lam, u = self.weights, self.u
        utu = u.T @ u
        utu_m1 = utu ** (m - 1)
        utu_m = utu_m1 * utu
        y = torch.func.vmap(lambda col: _sym.ttsv(a, col, keep=1), in_dims=1, out_dims=1)(u)
        z = torch.sum(u * y, dim=0)
        f = data["norm_a_sqr"] - 2.0 * torch.dot(lam, z) + lam @ utu_m @ lam
        g_lam = -2.0 * z + 2.0 * (utu_m @ lam)
        g_u = -2.0 * m * y * lam[None, :] + 2.0 * m * (u * lam[None, :] @ utu_m1 * lam[None, :])
        return f, torch.cat([g_lam, g_u.T.reshape(-1)])

    def __repr__(self):
        return (f"SymKTensor(n={self.u.shape[0]}, rank={self.u.shape[1]}, m={self.order}, "
                f"device={self.u.device})")


class SumTensor:
    """Lazy sum of tensors of any class — ``@sumtensor``. The parts densify
    only in ``full``; ``innerprod``, ``mttkrp`` and ``ttv`` distribute over
    them, each part by its own method."""

    def __init__(self, parts):
        self.parts = [p if isinstance(p, (Tensor, SpTensor, KTensor, TTensor)) else Tensor(p)
                      for p in parts]

    @property
    def shape(self):
        return tuple(self.parts[0].shape)

    @property
    def ndim(self):
        return len(self.shape)

    def __add__(self, other) -> "SumTensor":
        if isinstance(other, SumTensor):
            return SumTensor(self.parts + other.parts)
        return SumTensor(self.parts + [other])

    def full(self) -> Tensor:
        return Tensor(_tu.sumtensor_full([p.double() for p in self.parts]))

    def double(self) -> torch.Tensor:
        return self.full().data

    def innerprod(self, other) -> torch.Tensor:
        return sum(p.innerprod(other) for p in self.parts)

    def norm(self) -> torch.Tensor:
        return self.full().norm()

    def isscalar(self) -> bool:
        return False

    def __pos__(self):
        return self

    def __neg__(self) -> "SumTensor":
        return SumTensor([-p for p in self.parts])

    def mttkrp(self, factors, mode: int) -> torch.Tensor:
        """``@sumtensor/mttkrp.m``: MTTKRP distributes over the sum."""
        return sum(p.mttkrp(factors, mode) for p in self.parts)

    def ttv(self, vecs, modes=None) -> torch.Tensor:
        """``@sumtensor/ttv.m``: each part contracted by its own method, the
        densified results added."""
        outs = []
        for p in self.parts:
            o = p.ttv(vecs, modes) if modes is not None else p.ttv(vecs)
            outs.append(o.double() if _is_class(o) else o)
        return sum(outs[1:], outs[0])

    def __repr__(self):
        return f"SumTensor({len(self.parts)} parts, shape={self.shape})"


class TenMat:
    """Tensor-as-matrix — ``@tenmat``: a matricized view that remembers the
    original shape and the row/column mode split, so it converts back."""

    def __init__(self, data, row_modes, col_modes, tshape, device=None, dtype=None):
        (self.data,) = _placed([data], device, dtype)
        self.row_modes = tuple(int(m) for m in row_modes)
        self.col_modes = tuple(int(m) for m in col_modes)
        self.tshape = tuple(int(s) for s in tshape)

    @classmethod
    def from_tensor(cls, x, row_modes, col_modes=None, device=None, dtype=None) -> "TenMat":
        (x,) = _placed([_data_of(x)], device, dtype)
        n = x.ndim
        row_modes = (row_modes,) if isinstance(row_modes, int) else tuple(row_modes)
        if col_modes is None:
            col_modes = tuple(m for m in range(n) if m not in row_modes)
        else:
            col_modes = (col_modes,) if isinstance(col_modes, int) else tuple(col_modes)
        return cls(_tenmat_fn(x, row_modes, col_modes), row_modes, col_modes, x.shape)

    @property
    def shape(self):
        return tuple(self.data.shape)

    def tsize(self):
        """Original tensor shape — ``tsize.m``."""
        return self.tshape

    def double(self) -> torch.Tensor:
        return self.data

    def _like(self, data) -> "TenMat":
        return TenMat(data, self.row_modes, self.col_modes, self.tshape)

    def to_tensor(self) -> Tensor:
        """Invert the matricization (inverse of :meth:`from_tensor`)."""
        perm = self.row_modes + self.col_modes
        inv = [0] * len(perm)
        for pos, m in enumerate(perm):
            inv[m] = pos
        return Tensor(self.data.reshape(tuple(self.tshape[m] for m in perm)).permute(inv))

    @property
    def T(self) -> "TenMat":
        """``ctranspose.m``: swap the row/column mode split."""
        return TenMat(self.data.T, self.col_modes, self.row_modes, self.tshape)

    def norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.data.reshape(-1))

    def _op(self, other):
        return other.data if isinstance(other, TenMat) else _operand(other, self.data)

    def __add__(self, other):
        return self._like(self.data + self._op(other))

    def __sub__(self, other):
        return self._like(self.data - self._op(other))

    def __neg__(self):
        return self._like(-self.data)

    def __mul__(self, other):
        """``@tenmat/mtimes.m``: scalar scaling, or the matrix product whose
        tensor shape is A's row modes then B's column modes."""
        if not isinstance(other, TenMat):
            return self._like(self.data * other)
        tsiz = (tuple(self.tshape[m] for m in self.row_modes)
                + tuple(other.tshape[m] for m in other.col_modes))
        nr = len(self.row_modes)
        return TenMat(self.data @ other.data, tuple(range(nr)), tuple(range(nr, len(tsiz))), tsiz)

    __rmul__ = __mul__

    def __pos__(self):
        return self

    def __getitem__(self, idx):
        """``@tenmat/subsref.m`` — matrix indexing on the data."""
        return self.data[idx]

    def with_set(self, idx, value) -> "TenMat":
        """Functional subscripted assignment — ``@tenmat/subsasgn.m``."""
        data = self.data.clone()
        data[idx] = _operand(_data_of(value), data)
        return self._like(data)

    def __repr__(self):
        return (f"TenMat(shape={self.shape}, rows={self.row_modes}, "
                f"cols={self.col_modes}, tshape={self.tshape})")


class SpTenMat:
    """Sparse tensor-as-matrix — ``@sptenmat``: COO matricization keeping
    the mode split and the original shape for the round trip; indices
    int64."""

    def __init__(self, vals, row_idx, col_idx, row_modes, col_modes, tshape, device=None, dtype=None):
        self.vals, row_idx, col_idx = _placed([vals, row_idx, col_idx], device, dtype)
        self.row_idx, self.col_idx = row_idx.to(torch.int64), col_idx.to(torch.int64)
        self.row_modes = tuple(int(m) for m in row_modes)
        self.col_modes = tuple(int(m) for m in col_modes)
        self.tshape = tuple(int(s) for s in tshape)

    @property
    def shape(self):
        return (math.prod(self.tshape[m] for m in self.row_modes),
                math.prod(self.tshape[m] for m in self.col_modes))

    @property
    def nnz(self):
        return self.vals.shape[0]

    def double(self) -> torch.Tensor:
        """Dense matrix — ``@sptenmat/double.m`` (duplicates accumulate)."""
        out = torch.zeros(self.shape, dtype=self.vals.dtype, device=self.vals.device)
        return out.index_put_((self.row_idx, self.col_idx), self.vals, accumulate=True)

    def to_sptensor(self) -> SpTensor:
        """Invert the matricization back to COO tensor coordinates."""
        subs = torch.zeros((self.nnz, len(self.tshape)), dtype=torch.int64, device=self.row_idx.device)
        for modes, idx in ((self.row_modes, self.row_idx), (self.col_modes, self.col_idx)):
            if modes:
                subs[:, list(modes)] = _sp.sp_ind2sub(idx, tuple(self.tshape[m] for m in modes))
        return SpTensor(self.vals, subs, self.tshape)

    def tsize(self):
        """Original tensor shape — ``@sptenmat/tsize.m``."""
        return self.tshape

    def full(self) -> TenMat:
        """Densify to a tenmat — ``@sptenmat/full.m``."""
        return TenMat(self.double(), self.row_modes, self.col_modes, self.tshape)

    def norm(self) -> torch.Tensor:
        """Frobenius norm — ``@sptenmat/norm.m``, of the assembled matrix
        (duplicates accumulate before squaring)."""
        return torch.linalg.vector_norm(self.double().reshape(-1))

    def __neg__(self) -> "SpTenMat":
        return SpTenMat(-self.vals, self.row_idx, self.col_idx, self.row_modes, self.col_modes, self.tshape)

    def __pos__(self):
        return self

    def aatx(self, x) -> torch.Tensor:
        """A·Aᵀ·x without assembling A — ``@sptenmat/aatx.m:25-35``:
        t = Aᵀx and y = A·t as two gather/`index_add_` passes over the stored
        (row, col, val) triples, O(nnz)."""
        x = _on(x, self.vals)
        nr, nc = self.shape
        t = torch.zeros((nc,), dtype=self.vals.dtype, device=self.vals.device)
        t.index_add_(0, self.col_idx, self.vals * x[self.row_idx])
        y = torch.zeros((nr,), dtype=self.vals.dtype, device=self.vals.device)
        return y.index_add_(0, self.row_idx, self.vals * t[self.col_idx])

    def __repr__(self):
        return f"SpTenMat(shape={self.shape}, nnz={self.nnz}, device={self.vals.device})"
