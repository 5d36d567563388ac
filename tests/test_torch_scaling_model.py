"""PyTorch port, the scaling model (`tritd_tpu_torch/tools/scaling_model.py`,
counterpart of the reference's `tools/scaling_model.py`): its closed-form
payload against what `SlabCollective` counts in a two-rank gloo run on the
CPU, and the document and JSON line it makes from given rows, every
multi-GPU figure marked predicted. Exact: the counts are integers."""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tritd_tpu_torch.parallel.distributed import launch_local  # noqa: E402
from tritd_tpu_torch.tools import scaling_model as sm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's model, tools/scaling_model.py (no JAX in it), loaded from its file
_spec = importlib.util.spec_from_file_location("ref_scaling_model", os.path.join(REPO, "tools", "scaling_model.py"))
ref_sm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_sm)

SHAPE = (22, 13, 17)
RANK = 2


@pytest.mark.parametrize("mode", [1, 3])
def test_closed_form_payload_is_what_two_gloo_ranks_count(tmp_path, mode):
    out = str(tmp_path / "w.npz")
    launch_local(2, ["--device", "cpu", "--backend", "gloo", "--shape", ",".join(map(str, SHAPE)),
                     "--rank-r", str(RANK), "--max-iter", "3", "--shard-mode", str(mode), "--out", out],
                 timeout_s=240.0, env={**os.environ, "OMP_NUM_THREADS": "1"})
    with np.load(out) as f:
        calls, words, nbytes = (int(f[f"all_reduce_{k}_per_iter"]) for k in ("calls", "words", "bytes"))
    # the worker's first run passes the origin: the RRE numerator is the third scalar
    want = sm.payload_words(SHAPE, RANK, mode=mode, with_origin=True)
    assert (calls, words, nbytes) == (sm.ROUNDS, want, 4 * want)
    if mode == 1:
        # the reference's closed form counts a second r^4 Gram and four
        # scalars: the port reduces GramA alone (GramB and GramC are whole
        # on every shard) and three scalars
        assert ref_sm.payload_bytes(SHAPE[1], SHAPE[2], RANK) == sm.reference_payload_bytes(SHAPE[1], SHAPE[2], RANK)
        assert sm.reference_payload_bytes(SHAPE[1], SHAPE[2], RANK) - nbytes == 4 * (RANK**4 + 1)


def test_model_keeps_the_reference_formula():
    for args in ((151.57, 8, 40216, 4e-6, 45e9), (993.0, 16, 40216, 40e-6, 25e9, 8)):
        assert sm.t_iter(*args) == pytest.approx(ref_sm.t_iter(*args[:5], rounds=args[5] if len(args) > 5 else 4))


def test_document_and_json_line_from_given_rows(tmp_path, capsys):
    rows = [{"name": "taxi", "shape": [100, 100, 500], "rank": 5, "ms_per_iter": 1.8,
             "card": "NVIDIA H100 80GB HBM3, 700.00 W",
             "all_reduce": {"calls": 4, "words": 15628, "bytes": 62512}},
            {"name": "video", "shape": [240, 320, 300], "rank": 5, "ms_per_iter": 1.6,
             "card": "NVIDIA H100 80GB HBM3, 700.00 W"}]
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(rows))
    out = tmp_path / "doc" / "SCALING_MODEL.md"
    result = sm.main(["--rows", str(path), "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result)) and line["predicted"] is True and line["out"] == str(out)
    taxi, video = line["rows"]
    assert taxi["payload_counted"] and taxi["payload_bytes"] == 62512 and taxi["rounds"] == 4
    assert not video["payload_counted"] and video["payload_bytes"] == 4 * sm.payload_words((240, 320, 300), 5)
    t8 = sm.t_iter(1800.0, 8, 62512, sm.NVLINK_LAT, sm.NVLINK_BW)
    assert taxi["predicted_us"]["8"] == pytest.approx(t8)
    assert taxi["predicted_efficiency"]["8"] == pytest.approx(1800.0 / (8 * t8))
    doc = out.read_text()
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in doc and "assumed, not\nmeasured" in doc.lower()
    table = [ln for ln in doc.splitlines() if ln.startswith("| taxi") or ln.startswith("| video")]
    assert len(table) == 2
    for ln in table:
        cells = [c.strip() for c in ln.strip("|").split("|")]
        assert all(c.startswith("predicted") for c in cells[4:]), cells  # every multi-GPU figure
    assert sm.DEFAULT_OUT.startswith("results/")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "results/" in f.read().split()
