"""Comparison baseline suite: PyTorch counterparts of the JAX package's
reimplementations of the vendored methods the reference benchmarks against
(`tritd_tpu/baselines/`)."""

from .ttnn import tt_trpca, weight_tc
from .rtrc import rtrc, freedom_ratio
from .rc_fctn import (
    rc_fctn,
    rc_fctn_driver_traffic,
    rc_fctn_driver_video,
    balanced_bipartitions,
    weight_fctn,
)
from .sofia import (
    sofia_als,
    sofia_init,
    sofia_stream,
    sofia_stream_device,
    hw_fit,
    hw_forecast,
    hw_update,
)
from .trpca import trpca_tnn, trpca_snn, prox_tnn
from .rnc_fctn import rnc_fctn, fctn_compose

__all__ = [
    "tt_trpca",
    "weight_tc",
    "rtrc",
    "freedom_ratio",
    "rc_fctn",
    "rc_fctn_driver_traffic",
    "rc_fctn_driver_video",
    "balanced_bipartitions",
    "weight_fctn",
    "sofia_als",
    "sofia_init",
    "sofia_stream",
    "sofia_stream_device",
    "hw_fit",
    "hw_forecast",
    "hw_update",
    "trpca_tnn",
    "trpca_snn",
    "prox_tnn",
    "rnc_fctn",
    "fctn_compose",
]
