"""Reference-protocol oracle emulators (test-only, never a compute path).

Counterpart of `tritd_tpu/oracle/`: independent float64 numpy re-derivations
of the reference solvers under MATLAB column-major semantics (order='F'
reshapes, pinv solves, the exact reference control flow). The port's solvers
and baselines are held to them trajectory by trajectory at tiny shapes
(`tests/test_torch_admm.py`, `tests/test_torch_baselines.py`,
`tests/test_torch_sofia.py`).
"""

from .matlab_emulator import (
    rc_fctn_em,
    rtrc_em,
    sofia_init_em,
    tritd_admm_em,
    tt_trpca_em,
)

__all__ = [
    "tritd_admm_em",
    "tt_trpca_em",
    "rtrc_em",
    "rc_fctn_em",
    "sofia_init_em",
]
