"""chip_smoke.py on the CPU: the script refuses to run without a GPU, and
each phase's checks pass at a tiny size (the card runs them at full size).
The four-card phase runs on four of the eight virtual CPU devices."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

TINY = dict(m=300, n=120, nnz=6000, k=4, iters=2)


@pytest.fixture
def state():
    return {"clock": chip_smoke.CompileClock()}


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--multi"]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out


def test_device_phase_needs_gpu(state):
    with pytest.raises(chip_smoke.SmokeError, match="needs a GPU"):
        chip_smoke.phase_device(state)


def test_run_phases_reports_each_phase(state, capsys):
    def bad(state):
        chip_smoke.check(False, "broken")

    ok = chip_smoke.run_phases([("good", lambda s: {"x": 1}),
                                ("bad", bad), ("after", lambda s: {})],
                               state)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert not ok
    assert [(ln["phase"], ln["ok"]) for ln in lines] == [
        ("good", True), ("bad", False), ("after", True)]
    assert "broken" in lines[1]["error"]


def test_kernels_phase_tiny(state):
    out = chip_smoke.phase_kernels(
        state, kernel=dict(M=300, W=200, check_rows=64),
        solve=dict(m=400, n=150, nnz=12_000, k=8))
    assert out["panel"]["update_bit_mismatches"] == 0
    assert out["als_solve"]["max_rel_err"] <= 1e-4
    assert "temp_size_in_bytes" in out["panel"]["memory"]["panel_usweep"]


def test_golden_phase_tiny(state):
    out = chip_smoke.phase_golden(state, dims=TINY)
    assert set(out) == {"ccd_dense", "ccd_hybrid", "ccd_hybrid_panel_kernel",
                        "als_ell"}


def test_ccd_then_serve_phases_tiny(state):
    # AUTO picks the dense backend at this size; the headline flags force
    # the hybrid one
    out = chip_smoke.phase_ccd(state, dims=dict(TINY, iters=3))
    assert out["default"]["backend"] == "dense"
    assert out["headline"]["backend"] == "hybrid"
    assert len(out["headline"]["rmse"]) == 3
    serve = chip_smoke.phase_serve(state, users=32, topk=5)
    assert serve["sets_differing"] == serve["tie_exempt"]


def test_serve_phase_needs_trained_factors(state):
    with pytest.raises(chip_smoke.SmokeError, match="phase ccd"):
        chip_smoke.phase_serve(state)


def test_als_phase_tiny(state):
    out = chip_smoke.phase_als(state, dims=TINY)
    assert out["backend"] == "ell" and len(out["rmse"]) == 2


def test_multi_phase_on_four_virtual_devices(state):
    out = chip_smoke.phase_multi(state, ccd=TINY, als=TINY, n_dev=4)
    for name in ("ccd_hybrid", "als_ell"):
        assert out[name]["row_sharded_arrays"] > 0
        assert out[name]["rmse_rel_gap"] <= 1e-4


def test_past_bar_measures_only_entries_the_relative_bar_fails():
    A = [[1.0, 0.001, 0.0]]
    B = [[1.05, 0.002, 0.0]]          # 5% off passes; 50% off is past the bar
    assert chip_smoke._past_bar(A, B) == pytest.approx(0.001)
    assert chip_smoke._past_bar(B, B) == 0.0
