"""The reference's published benchmark numbers + the mechanical parity check.

Counterpart of `tritd_tpu/utils/published.py`, with the same tables and
messages. It is pure Python, but importing it from `tritd_tpu` would load
JAX through that package's `__init__`, so the port keeps its own copy (the
tests hold the two equal).

Single source of truth for every published cell the framework compares
against (BASELINE.md):

* completion RRE + wall-clock — reference `README.md:57-63` (10% uniform
  missing, TriTD rank r=5);
* video wall-clock — reference `README.md:71-77` = `foreground_grid.m:9-14`
  (300 CDnet2014 frames; no per-cell quality metric is published).

`check_parity` is the `--verify-parity` CLI mode (VERDICT r3 #6): the
real-data RRE columns are environment-blocked today (zero network egress —
docs/DATA.md), so parity on them cannot be *demonstrated* yet; this makes it
a one-command check the day the `.mat` files exist, and a loud failure until
then.
"""

from __future__ import annotations

# Method keys follow the CLI names: triple = TriTD-ADMM (ours),
# ring = TRLRF/RTRC, fctn = RC-FCTN, ttnn = TT-TRPCA, sofia = SOFIA.

#: Completion RRE at 10% uniform missing — `README.md:57-63`.
PUBLISHED_RRE: dict[str, dict[str, float]] = {
    "sofia": {"sensor": 0.341, "taxi": 0.584, "network": 0.963, "chicago": 0.352},
    "ring": {"sensor": 0.316, "taxi": 0.280, "network": 0.126, "chicago": 0.311},
    "fctn": {"sensor": 0.337, "taxi": 0.380, "network": 1.083, "chicago": 0.247},
    "ttnn": {"sensor": 0.558, "taxi": 0.307, "network": 0.999, "chicago": 0.316},
    "triple": {"sensor": 0.279, "taxi": 0.338, "network": 0.143, "chicago": 0.321},
}

#: Wall-clock seconds — completion `README.md:59-63`, video `README.md:73-76`.
PUBLISHED_SECONDS: dict[str, dict[str, float]] = {
    "sofia": {"sensor": 15.95, "taxi": 598.24, "network": 12.01, "chicago": 194.36,
              "highway": 370.57, "sofa": 419.57, "office": 424.15, "PETS2006": 395.39},
    "ring": {"sensor": 25.58, "taxi": 1799.52, "network": 41.06, "chicago": 1318.22,
             "highway": 1031.97, "sofa": 1147.48, "office": 1148.17, "PETS2006": 1215.11},
    "fctn": {"sensor": 2.46, "taxi": 128.44, "network": 5.08, "chicago": 29.30,
             "highway": 50.64, "sofa": 56.92, "office": 56.64, "PETS2006": 92.62},
    "ttnn": {"sensor": 4.45, "taxi": 340.42, "network": 7.39, "chicago": 264.73,
             "highway": 201.47, "sofa": 225.50, "office": 226.36, "PETS2006": 229.23},
    "triple": {"sensor": 2.53, "taxi": 53.90, "network": 1.72, "chicago": 20.69,
               "highway": 33.68, "sofa": 37.05, "office": 43.98, "PETS2006": 35.93},
}

#: Default RRE tolerance for `--verify-parity`: two-sided — the run must
#: land within this of the published value (the reference states no
#: variance; 0.05 absolute covers seed/fp differences without letting a
#: wrong algorithm pass).
DEFAULT_RRE_GAP = 0.05


def check_parity(
    rows: list[dict],
    gap: float = DEFAULT_RRE_GAP,
    max_iter: int | None = None,
    missing_ratio: float | None = None,
) -> list[str]:
    """Mechanically check a list of CLI result rows against the published
    tables. Returns failure messages (empty list = parity holds).

    `max_iter` / `missing_ratio` are the PROTOCOL the caller ran (pass the
    CLI args): the published numbers are 100 iterations at 10% uniform
    missing (reference `README.md:53`), so a run at a different protocol
    must fail rather than "pass" a check it never executed (r4 review —
    e.g. --max-iter 10 trivially beats every published wall-clock).

    Per row (needs keys dataset/method/provenance, plus rre or seconds):

    * provenance != "mat" → failure: parity is only meaningful on the real
      datasets (synthetic stand-ins share shapes, not values).
    * completion datasets (a published RRE exists): |rre - published| must
      be <= gap.
    * video datasets (only wall-clock is published): measured seconds must
      beat the published MATLAB seconds (hardware differs — that is the
      claim being made).
    * no published cell for (method, dataset) → failure (nothing to verify
      against).
    """
    failures = []
    if max_iter is not None and max_iter != 100:
        failures.append(
            f"protocol: max_iter={max_iter} != 100 — the published tables"
            " are 100-iteration runs (README.md:53); rerun with"
            " --max-iter 100"
        )
    if missing_ratio is not None:
        # The two published protocols differ BY ROW KIND: completion RRE is
        # at 10% uniform missing (README.md:53), video wall-clock at
        # missing rate 0 (video_triple_comparison.m:5) — gate each class
        # against its own protocol (r4 review: a single global 0.10 gate
        # contradicted the video rows it was supposed to protect).
        def _published_kind(r):
            m = "triple" if r.get("method") == "triple_masked" else r.get("method")
            if PUBLISHED_RRE.get(m, {}).get(r.get("dataset")) is not None:
                return "completion"
            if PUBLISHED_SECONDS.get(m, {}).get(r.get("dataset")) is not None:
                return "video"
            return None

        kinds = {_published_kind(r) for r in rows}
        if "completion" in kinds and abs(missing_ratio - 0.10) > 1e-9:
            failures.append(
                f"protocol: missing_ratio={missing_ratio} != 0.10 — the"
                " published completion RREs are at 10% uniform missing"
                " (README.md:53; note the CLI default is the committed"
                " driver's 0.15 quirk); rerun with --missing-ratio 0.10"
            )
        if "video" in kinds and abs(missing_ratio) > 1e-9:
            failures.append(
                f"protocol: missing_ratio={missing_ratio} != 0 — the"
                " published video wall-clocks are at missing rate 0"
                " (`video_triple_comparison.m:5`); rerun with"
                " --missing-ratio 0"
            )
    for row in rows:
        ds, method = row.get("dataset"), row.get("method")
        tag = f"{method}:{ds}"
        if method == "triple_masked":
            method = "triple"  # same published row; the mask handling differs
        if row.get("provenance") != "mat":
            failures.append(
                f"{tag}: provenance={row.get('provenance')!r} — parity is"
                " only verifiable on the real .mat datasets (docs/DATA.md)"
            )
            continue
        pub_rre = PUBLISHED_RRE.get(method, {}).get(ds)
        if pub_rre is not None:
            rre = row.get("rre")
            if rre is None:
                failures.append(f"{tag}: row has no 'rre' field to check")
            elif abs(rre - pub_rre) > gap:
                failures.append(
                    f"{tag}: RRE {rre:.4f} vs published {pub_rre:.3f}"
                    f" (|diff| {abs(rre - pub_rre):.4f} > gap {gap})"
                )
            continue
        pub_s = PUBLISHED_SECONDS.get(method, {}).get(ds)
        if pub_s is not None:
            seconds = row.get("seconds")
            # A wall-clock-only cell (no published quality metric) may only
            # pass on an EXACT numerics route: a warm/randomized SVT run can
            # beat the clock while computing different numerics than the
            # reference path (r4 advisor). svd/gram are the exact routes
            # (gram is parity-pinned against svd at benchmark shape).
            svt = row.get("svt_method")
            if svt is not None and not (
                svt in ("svd", "gram") or svt.startswith("gram")
            ):
                failures.append(
                    f"{tag}: svt_method={svt!r} is an approximate route —"
                    " wall-clock-only parity requires the exact 'svd' or"
                    " 'gram' numerics; rerun with --svt-method gram"
                )
                continue
            if seconds is None:
                failures.append(f"{tag}: row has no 'seconds' field to check")
            elif seconds > pub_s:
                failures.append(
                    f"{tag}: {seconds:.2f} s does not beat the published"
                    f" {pub_s:.2f} s"
                )
            continue
        failures.append(f"{tag}: no published cell to verify against")
    if not rows:
        failures.append("no result rows produced — nothing verified")
    return failures
