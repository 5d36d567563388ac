"""PyTorch port: its own copy of the numpy MATLAB emulator
(`tritd_tpu_torch/oracle/`) against the original in `tritd_tpu/oracle/`.

The port imports nothing of the JAX package, so it keeps a copy of the
emulator its tests are held to. The two copies are pure numpy float64 and
must give the same outputs bit for bit on the same inputs: one call of each
emulator, every array of the returned dict compared with
`assert_array_equal`."""

import ast
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

from tritd_tpu import oracle as ref_oracle  # noqa: E402
from tritd_tpu.oracle import matlab_emulator as ref_em  # noqa: E402
from tritd_tpu_torch import oracle as port_oracle  # noqa: E402
from tritd_tpu_torch.oracle import matlab_emulator as port_em  # noqa: E402


def _problem(shape=(6, 5, 8), seed=0):
    """A small low-rank tensor with sparse spikes and a 20% missing mask."""
    rng = np.random.default_rng(seed)
    us = [rng.standard_normal((s, 2)) for s in shape]
    x = np.einsum("ir,jr,tr->ijt", *us)
    mask = rng.random(shape) > 0.2
    y = np.where(rng.random(shape) < 0.05, 5.0, x) * mask
    return rng, x, mask, y


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], (list, tuple)):
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=key)
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def _call(name):
    rng, x, mask, y = _problem()
    n1, n2, n3 = y.shape
    if name == "tritd_admm_em":
        r = 2
        init = (rng.standard_normal((n1, r, r)), rng.standard_normal((r, n2, r)),
                rng.standard_normal((r, r, n3)))
        return (y, *init), dict(max_iter=8, origin=x)
    if name == "tt_trpca_em":
        return (y, x), dict(max_iter=6)
    if name == "rtrc_em":
        return (y, mask.astype(np.float64), x), dict(mu=1e-1, max_iter=6)
    if name == "rc_fctn_em":
        shape4 = (n1, n2, 2, n3 // 2)
        args = (np.reshape(y, shape4, order="F"), 1.8,
                np.reshape(mask.astype(np.float64), shape4, order="F"),
                np.reshape(x, shape4, order="F"))
        return args, dict(f=0.7, maxit=6)
    if name == "sofia_als_em":
        init = tuple(rng.random((s, 2)) for s in y.shape)
        return (y, mask, 2, 4, 0.1, 0.001, init), dict(max_iters=10)
    raise AssertionError(name)


@pytest.mark.parametrize(
    "name", ["tritd_admm_em", "tt_trpca_em", "rtrc_em", "rc_fctn_em", "sofia_als_em"]
)
def test_the_two_copies_give_equal_outputs(name):
    args, kwargs = _call(name)
    want = getattr(ref_em, name)(*args, **kwargs)
    got = getattr(port_em, name)(*args, **kwargs)
    _same(got, want)
    # the run did something: a history with finite entries came back
    hist = next(np.asarray(v, float) for k, v in want.items() if "hist" in k or k == "rse_real") \
        if name != "sofia_als_em" else np.asarray(want["x_hat"])
    assert hist.size and np.isfinite(hist).all()


def test_the_copy_exports_the_same_names_and_imports_only_numpy():
    assert port_oracle.__all__ == ref_oracle.__all__
    for name in ref_oracle.__all__:
        assert callable(getattr(port_oracle, name))
    tree = ast.parse(pathlib.Path(port_em.__file__).read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert imported == {"__future__", "itertools", "math", "numpy"}
    # the same functions, in the same order, as the original defines
    def defs(mod):
        return [n.name for n in ast.parse(pathlib.Path(mod.__file__).read_text()).body
                if isinstance(n, ast.FunctionDef)]

    assert defs(port_em) == defs(ref_em)
