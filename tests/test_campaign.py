"""Double-gyre campaign acceptance gates.

The long-horizon validation of the f32 δ-formulation: the wind-driven
double-gyre experiment (reference Examples/double_gyre/numo3d.in) run for
100 model days in f64 on CPU (the truth band) and in f32 on an H100 on the
default path, comparing the reference's own KE diagnostic
(Examples/double_gyre/compute_ke.m; docs/source/test.rst:55-66 judges the
reference on exactly these curves). The campaigns are produced by
tools/dgyre_campaign.py and committed as docs/artifacts/*.json; this test
replays the acceptance band against them every suite run.
"""
import json
import os

import numpy as np
import pytest

ART = os.path.join(os.path.dirname(__file__), "..", "docs", "artifacts")


def _load(name):
    path = os.path.join(ART, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not present")
    with open(path) as f:
        return json.load(f)


def test_f64_band_complete():
    d = _load("dgyre_f64_cpu.json")
    assert d["complete"], "f64 campaign did not reach its horizon"
    assert d["ok"]
    assert d["records"][-1]["t_days"] >= 99.0
    # mass conservation over the full campaign (reference gate: 1e-12,
    # CI/bump/check.F90:58-74)
    assert d["mass_rel_drift"] < 1e-12
    # spin-up sanity: wind input must grow KE monotonically-ish early on
    ke = [r["ke_total"] for r in d["records"]]
    assert ke[-1] > ke[0] > 0


def test_f32_h100_tracks_f64_band():
    """f32 production-path curves stay inside the f64 acceptance band.

    Gates follow the reference's own judging diagnostic — the KE curve of
    compute_ke.m (docs/source/test.rst:55-66) — plus velocity magnitude,
    over the FULL horizon, and pointwise SSH extrema only through the
    deterministic spin-up phase. After the jet instability onset (~day 30
    at this resolution) pointwise extrema phase-diverge chaotically
    between ANY two roundings (two f32 paths differ from each other as
    much as from f64) while the integral KE stays close; gating late-phase
    pointwise extrema would test eddy phase, not correctness.
    docs/float32.md discusses the measured envelopes."""
    d64 = _load("dgyre_f64_cpu.json")
    d32 = _load("dgyre_f32_h100.json")
    assert d32["complete"] and d32["ok"]
    assert d32["mass_rel_drift"] < 1e-5, "f32 telescoping mass leak"
    r64 = {round(r["t_days"], 3): r for r in d64["records"]}
    r32 = {round(r["t_days"], 3): r for r in d32["records"]}
    common = sorted(set(r64) & set(r32))
    assert len(common) >= 100, "campaigns sample different time grids"
    ke64 = np.array([r64[t]["ke_total"] for t in common])
    ke32 = np.array([r32[t]["ke_total"] for t in common])
    # KE: 2% relative with an absolute floor over the near-zero spin-up
    # samples (KE in the 1e4-scaled units of compute_ke.m)
    scale = np.maximum(np.abs(ke64), 0.05 * np.abs(ke64).max())
    rel = np.abs(ke32 - ke64) / scale
    assert rel.max() < 0.02, (
        f"f32 KE deviates from f64 band: max rel {rel.max():.3e} "
        f"at day {common[int(rel.argmax())]}")
    # velocity magnitude: 3% full-horizon
    u64 = np.array([r64[t]["umax"] for t in common])
    u32 = np.array([r32[t]["umax"] for t in common])
    urel = np.abs(u32 - u64) / np.maximum(u64, 0.05 * u64.max())
    assert urel.max() < 0.03, f"umax deviates: {urel.max():.3e}"
    # SSH extrema: deterministic phase only (pre-instability)
    early = [t for t in common if t <= 25.0]
    s64 = np.array([[r64[t]["ssh_min"], r64[t]["ssh_max"]] for t in early])
    s32 = np.array([[r32[t]["ssh_min"], r32[t]["ssh_max"]] for t in early])
    sscale = np.abs(s64).max()
    assert np.abs(s32 - s64).max() / sscale < 0.10
