"""Config semantics: reference `parameter` parity quirks and validation."""

import pytest

from cuda_recommender_tpu.core.config import Backend, Config, Solver


def test_defaults_match_reference():
    """Defaults from /root/reference/src/pmf.h:26-42 (note maxinneriter's
    CODE default is 1, not the help text's claimed 5)."""
    c = Config()
    assert (c.k, c.maxiter, c.maxinneriter) == (10, 5, 1)
    assert c.lambda_ == pytest.approx(0.1)
    assert c.threads == 4 and c.eps == pytest.approx(1e-3)
    assert c.solver == Solver.CCD


def test_do_predict_forces_verbose():
    """src/extras.cpp:130-132."""
    assert Config(do_predict=True).verbose


def test_validation():
    with pytest.raises(ValueError):
        Config(k=0)
    with pytest.raises(ValueError):
        Config(maxinneriter=0)
    with pytest.raises(ValueError):
        Config(ell_min_width=6)


def test_auto_backend_resolution():
    c = Config(backend="auto", dense_max_cells=1000)
    assert c.resolve_backend(10, 10) == Backend.DENSE
    assert c.resolve_backend(1000, 1000) == Backend.HYBRID
    assert Config(backend="auto", dense_max_cells=1000,
                  hybrid_dense_cells=0).resolve_backend(1000, 1000) == Backend.ELL
    assert Config(solver="als", backend="auto").resolve_backend(5, 5) == Backend.ELL
    assert Config(backend="ell").resolve_backend(5, 5) == Backend.ELL


def test_string_coercion():
    c = Config(solver="als", backend="dense")
    assert c.solver is Solver.ALS and c.backend is Backend.DENSE


def test_als_explicit_dense_pallas_normalize_to_ell():
    """ALS has exactly one compiled path; an explicit dense/hybrid request
    resolves to ELL so reported backend == executed backend. The removed
    ``pallas`` backend is rejected."""
    assert Config(solver="als", backend="dense").resolve_backend(5, 5) == Backend.ELL
    assert Config(solver="als", backend="hybrid").resolve_backend(5, 5) == Backend.ELL
    with pytest.raises(ValueError):
        Config(solver="als", backend="pallas")
    assert Config(solver="als", backend="ref").resolve_backend(5, 5) == Backend.REF


def test_solver_knob_validation():
    with pytest.raises(ValueError):
        Config(als_solver="GJ")
    with pytest.raises(ValueError):
        Config(als_solver="gj")            # the removed Pallas solve
    with pytest.raises(ValueError):
        Config(als_precision="bf16")
    Config(als_precision="high")        # bf16_3x — valid since round 2
    with pytest.raises(ValueError):
        Config(residual_dtype="float16")
