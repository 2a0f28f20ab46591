"""Checks that need an NVIDIA GPU: the Pallas panel kernels compiled through
Triton (the CPU tests interpret them) and the ALS solve through cuSOLVER /
cuBLAS, each against its plain reference. Skipped where JAX has no GPU;
run them on a card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("M,W", [(4096, 17_770), (1000, 333)])
def test_panel_kernels_compiled(gpu, M, W):
    out = chip_smoke.check_panel_kernels(M, W, check_rows=min(M, 512))
    assert out["update_bit_mismatches"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 40])
def test_als_solve_on_gpu(gpu, k):
    out = chip_smoke.check_als_solve(m=5000, n=1500, nnz=300_000, k=k)
    assert out["max_rel_err"] <= 1e-4
