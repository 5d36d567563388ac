"""Analytic multi-GPU scaling model of the sharded TriTD-ADMM solve.

Counterpart of the reference's `tools/scaling_model.py`, with its model:

    T(N) = T1/N + rounds * latency + payload * 2(N-1)/N / bandwidth

per iteration, a ring all-reduce's payload factor. What goes in is the
port's own:

* T1, the one-card time of an iteration, is measured: rows of a JSON file
  (`--rows`) that `chip_smoke.py` writes from its single-card solves
  (CUDA events around a 100-iteration solve), one row per configuration:
  {"name", "shape", "rank", "ms_per_iter", "card"}, and optionally the
  counted collectives of a sharded run of the same shape
  ({"all_reduce": {"calls", "words", "bytes"}} per iteration).
* rounds and payload are what `parallel.sharded_admm.SlabCollective`
  counts: 4 `all_reduce` calls an iteration, of `payload_words` words.
  Rows without a count take the closed form. The reference's closed form
  (`reference_payload_bytes`, from its HLO audit) is printed beside them.
* the interconnect is the H100's, as parameters: NVLink 4 within a host,
  450 GB/s each way per GPU (data sheet), and NDR InfiniBand across hosts,
  50 GB/s per GPU (one 400 Gb/s port a GPU). Both latencies are
  assumptions: no machine so far had more than one card.

Every multi-GPU figure is a prediction and is labelled so. The document
goes to `--out` (default under `results/`), one JSON line to stdout.

    python -m tritd_tpu_torch.tools.scaling_model --rows results/scaling_rows.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

NVLINK_BW = 450e9    # bytes/s each way per GPU, NVLink 4 (H100 SXM data sheet)
NVLINK_LAT = 15e-6   # s per all_reduce within a host over NVLink: an assumption
IB_BW = 50e9         # bytes/s per GPU across hosts, one NDR 400 Gb/s port a GPU
IB_LAT = 30e-6       # s per all_reduce across hosts: an assumption
GPUS_PER_HOST = 8
ROUNDS = 4           # all_reduce calls an iteration, as SlabCollective counts them
INTRA_HOST = (2, 4, 8)
DEFAULT_OUT = "results/SCALING_MODEL.md"


def payload_words(shape, rank: int, mode: int = 1, with_origin: bool = False) -> int:
    """Words one iteration's collectives carry (`solvers/admm.py`, the
    `shard` hook): mode-1 slabs reduce GramA (r^4) and the mode-2 and mode-3
    right-hand sides ((n2 + n3) r^2); mode-3 frames GramC and the mode-1
    and mode-2 ones ((n1 + n2) r^2); both the two residual sums, and the RRE
    numerator when an origin is given."""
    n1, n2, n3 = shape
    r2 = rank * rank
    sides = n2 + n3 if mode == 1 else n1 + n2
    return r2 * r2 + sides * r2 + 2 + int(with_origin)


def reference_payload_bytes(n2: int, n3: int, r: int = 5) -> int:
    """The reference's closed form for mode-1 slabs, from its HLO audit
    (`tools/scaling_model.py::payload_bytes`): two r^4 Grams, the two
    right-hand sides and four scalars, in float32. The port reduces one
    Gram (GramB and GramC are whole on every shard) and two or three
    scalars, so its payload is r^4 + 1 or 2 words smaller."""
    return 4 * (2 * r**4 + (n2 + n3) * r**2 + 4)


def t_iter(t1_us: float, n: int, payload: int, lat: float, bw: float, rounds: int = ROUNDS) -> float:
    """Predicted microseconds an iteration on n GPUs: the slab's share of
    the one-card time plus the collectives' latency and ring bandwidth."""
    return t1_us / n + rounds * lat * 1e6 + payload * (2 * (n - 1) / n) / bw * 1e6


def predict(row: dict) -> dict:
    """The predictions of one measured row."""
    shape, rank = tuple(row["shape"]), int(row["rank"])
    t1 = float(row["ms_per_iter"]) * 1e3
    counted = row.get("all_reduce")
    closed = payload_words(shape, rank) * 4  # float32 words
    payload = int(counted["bytes"]) if counted else closed
    rounds = int(counted["calls"]) if counted else ROUNDS
    within = {n: t_iter(t1, n, payload, NVLINK_LAT, NVLINK_BW, rounds) for n in INTRA_HOST}
    t16 = t_iter(t1, 2 * GPUS_PER_HOST, payload, IB_LAT, IB_BW, rounds)
    return {
        "name": row["name"], "shape": list(shape), "rank": rank, "t1_us_measured": t1,
        "rounds": rounds, "payload_bytes": payload, "payload_counted": counted is not None,
        "payload_bytes_closed_form": closed,
        "reference_payload_bytes": reference_payload_bytes(shape[1], shape[2], rank),
        "predicted_us": {str(n): t for n, t in within.items()} | {"16 (2 hosts)": t16},
        "predicted_efficiency": {str(n): t1 / (n * t) for n, t in within.items()}
        | {"16 (2 hosts)": t1 / (16 * t16)},
        "predicted_1to2_host_efficiency": within[GPUS_PER_HOST] / t16 / 2.0,
    }


def document(rows: list[dict], preds: list[dict]) -> str:
    card = sorted({str(r.get("card", "not stated")) for r in rows})
    lines = [
        "# Multi-GPU scaling model of the sharded TriTD-ADMM solve (predicted)",
        "",
        "Generated by `python -m tritd_tpu_torch.tools.scaling_model`. Model per iteration:",
        "`T(N) = T1/N + rounds * latency + payload * 2(N-1)/N / bandwidth`.",
        "",
        f"Measured: T1, the one-card time an iteration ({'; '.join(card)}). Counted: rounds and payload",
        "(`SlabCollective`), or the closed form `payload_words` where a row has no count. Assumed, not",
        f"measured: NVLink 4 {NVLINK_BW / 1e9:.0f} GB/s each way per GPU with {NVLINK_LAT * 1e6:.0f} us an all_reduce",
        f"within a host; NDR InfiniBand {IB_BW / 1e9:.0f} GB/s per GPU with {IB_LAT * 1e6:.0f} us an all_reduce across",
        "hosts. No machine so far had more than one card: **every multi-GPU figure below is predicted**.",
        "",
        "## Mode-1 slabs, one problem (predicted)",
        "",
        "| config | T1 us (measured) | rounds | payload B (counted / closed form / reference's) "
        "| predicted us at 2 / 4 / 8 GPUs (NVLink) | predicted us at 16 (2 hosts) "
        "| predicted efficiency 2 / 4 / 8 / 16 | predicted 1->2 host efficiency |",
        "| --- | --- | --- | --- | --- | --- | --- | --- |",
    ]
    for p in preds:
        us, eff = p["predicted_us"], p["predicted_efficiency"]
        keys = [str(n) for n in INTRA_HOST]
        lines.append(
            f"| {p['name']} {'x'.join(map(str, p['shape']))} r={p['rank']} | {p['t1_us_measured']:.1f} | {p['rounds']} "
            f"| {p['payload_bytes'] if p['payload_counted'] else 'not counted'} / {p['payload_bytes_closed_form']} "
            f"/ {p['reference_payload_bytes']} "
            f"| predicted {' / '.join(f'{us[k]:.1f}' for k in keys)} | predicted {us['16 (2 hosts)']:.1f} "
            f"| predicted {' / '.join(f'{100 * eff[k]:.0f}%' for k in (*keys, '16 (2 hosts)'))} "
            f"| predicted {100 * p['predicted_1to2_host_efficiency']:.0f}% |")
    lines += [
        "",
        "The latency term (rounds x latency) is fixed per iteration, so the shorter T1 is, the less a",
        "slab split can save: a one-card iteration that the host already bounds leaves little to divide.",
        "",
        "## Data parallel across hosts (predicted)",
        "",
        "`tritd_admm_batch_sharded` puts independent problems on the data axis: no collective of the loop",
        "crosses a host, so a host's predicted efficiency is that of its own slab split, and a second host",
        "adds a second batch at predicted 100% of its rate.",
        "",
        "## What is measured and what is not",
        "",
        "* T1: measured on one card (the rows' `card`). The rounds and bytes: counted on a sharded run",
        "  where a row carries them, else the closed form, which a 2-rank gloo test holds equal to the count.",
        "* NVLink and InfiniBand rates and latencies, NCCL's algorithm: not measured.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rows", required=True, help="JSON list of measured one-card rows")
    p.add_argument("--out", default=DEFAULT_OUT, help="where the document goes")
    a = p.parse_args(argv)
    rows = json.loads(Path(a.rows).read_text())
    preds = [predict(r) for r in rows]
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(document(rows, preds))
    result = {"out": str(out), "predicted": True, "rows": preds}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
