"""The plain references hold the port: in float64, where both compute the
same mathematics to rounding, they agree to 1e-9 on small shapes; the
stand-in generators make the shapes and the missing shares they state."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import run  # noqa: E402
from benchmark.data import traffic_standin, video_standin  # noqa: E402
from benchmark.methods.compare import relative_gap  # noqa: E402
from benchmark.reference import tritd_admm as ref_tritd, tt_trpca as ref_ttnn  # noqa: E402
from tritd_tpu_torch.baselines.ttnn import tt_trpca  # noqa: E402
from tritd_tpu_torch.solvers import TriTDConfig, tritd_admm  # noqa: E402

SMALL = {"taxi": [9, 8, 12], "highway": [16, 12, 10]}
ITERS = 8


def small_config(name: str) -> dict:
    config = run.load_json(run.BENCH / "configs" / f"{name}.json")
    config["shape"] = SMALL[name]
    return config


def small_data(name: str, seed: int = 3):
    config = small_config(name)
    make = {"traffic_standin": traffic_standin.make, "video_standin": video_standin.make}[config["generator"]]
    return config, make(config, torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed + 1),
                        torch.device("cpu"))


def history_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest |got[k] - ref[k]| over a history, in float64."""
    return float(torch.max(torch.abs(got.double() - ref.double())))


@pytest.mark.parametrize("name", ["taxi", "highway"])
def test_generators_make_the_stated_shapes_and_missing_share(name):
    config, data = small_data(name)
    assert len(data["observed"]) == config["masks"]
    total = torch.Size(config["shape"]).numel()
    for y in data["observed"]:
        assert y.shape == tuple(config["shape"]) and y.dtype == torch.float32
        assert int((y == 0).sum()) >= round(config["missing_ratio"] * total)
    if config["origin"]:
        masks = [y != 0 for y in data["observed"]]
        assert all(int((~m).sum()) == round(config["missing_ratio"] * total) for m in masks)
        assert not torch.equal(masks[0], masks[1])
    again = small_data(name)[1]
    assert all(torch.equal(u, v) for u, v in zip(data["observed"], again["observed"]))


@pytest.mark.parametrize("name", ["taxi", "highway"])
def test_tritd_admm_reference_holds_the_port_in_float64(name):
    config, data = small_data(name)
    preset = config["presets"]["tritd_admm"]
    d = data["observed"][0].double()
    origin = data["truth"].double() if config["origin"] else None
    n1, n2, n3 = d.shape
    r = preset["rank"]
    g = torch.Generator().manual_seed(5)
    init = tuple(torch.randn(s, generator=g, dtype=torch.float64) for s in ((n1, r, r), (r, n2, r), (r, r, n3)))
    cfg = TriTDConfig(**preset, max_iter=ITERS, tol=0.0, dtype="float64")
    got = tritd_admm(d, cfg, init=init, origin=origin)
    ref = ref_tritd.solve(d, init, preset, ITERS, origin=origin)
    for key in ("a", "b", "c", "o", "e"):
        assert relative_gap(getattr(got, key), ref[key]) < 1e-9, key
    assert history_gap(got.err_hist, ref["err_hist"]) < 1e-12
    if origin is not None:
        assert history_gap(got.rre_hist, ref["rre_hist"]) < 1e-12


def test_tt_trpca_reference_holds_the_port_in_float64():
    config, data = small_data("taxi")
    p = config["presets"]["tt_trpca"]
    y, x = data["observed"][0].double(), data["truth"].double()
    z, s, err, _n = tt_trpca(y, lam=p["lam"], f=p["f"], gamma=p["gamma"], deta=p["deta"], origin=x,
                             max_iter=ITERS, svt_method="svd")
    ref = ref_ttnn.solve(y, p, ITERS, origin=x)
    assert relative_gap(z, ref["z"]) < 1e-9
    assert relative_gap(s, ref["s"]) < 1e-9
    assert history_gap(err, ref["err_hist"]) < 1e-12


def test_tf32_rounding_keeps_ten_significand_bits_to_nearest_even():
    from benchmark.reference.precision import round_tf32

    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, -(1.0 + 2.0**-11), 3.0])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2.0**-9, 1.0 + 2.0**-10, -1.0, 3.0]
