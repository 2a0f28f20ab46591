"""Training configuration.

Carries the same semantic knob set as the reference's ``parameter`` class
(/root/reference/src/pmf.h:8-43) and its CLI (/root/reference/src/extras.cpp:68-141),
re-expressed for the JAX runtime: the CUDA launch-geometry knobs (nBlocks,
nThreadsPerBlock) become ELL/block-shape knobs, and the backend toggles
(-CUDA/-OMP) become ``backend`` / ``golden`` (run the compiled path, the reference
path, or both with cross-validation).

Reference quirks preserved deliberately:
  * ``maxinneriter`` defaults to 1 (the code default at src/pmf.h:31, not the help
    text's claimed 5 at src/extras.cpp:54).
  * ``eps`` exists but no solver consumes it (dead in the reference too);
    ``do_predict`` only forces ``verbose`` (src/extras.cpp:130-132).
  * ``do_nmf`` (-N) is parsed-but-dead in the reference (src/pmf.h:33, no use
    anywhere in src/). HERE it is implemented with the original libpmf CCD++
    semantics the flag was copied from: every rank-one update is clamped at 0,
    giving nonnegative factors. CCD++ only — the reference/libpmf ALS has no
    NMF path, so ALS ignores it like the reference does.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Solver(str, enum.Enum):
    CCD = "ccd"
    ALS = "als"


class Backend(str, enum.Enum):
    #: NumPy loop-faithful golden implementation (the reference-OMP role).
    REF = "ref"
    #: Compiled XLA dense-residual path (CCD) for matrices that fit.
    DENSE = "dense"
    #: Compiled XLA padded-ELL path (general sparse; the only ALS compiled path).
    ELL = "ell"
    #: Hybrid dense+ELL path (CCD, single chip): top-degree users get a dense
    #: residual sub-block (bandwidth-bound), the light tail stays
    #: padded-ELL. The large-matrix flagship: it moves most ratings off the
    #: gather path (solvers/ccd_hybrid.py).
    HYBRID = "hybrid"
    #: Pick the dense-residual path for CCD when it fits, the hybrid path for
    #: larger matrices (single device), ELL otherwise.
    AUTO = "auto"


@dataclasses.dataclass
class Config:
    # --- solver semantics (reference parity) ---
    solver: Solver = Solver.CCD            # -ALS flag flips to ALS
    k: int = 10                            # -k rank (src/pmf.h:27)
    maxiter: int = 5                       # -t outer iterations (src/pmf.h:30)
    maxinneriter: int = 1                  # -T inner iterations (src/pmf.h:31)
    lambda_: float = 0.1                   # -l regularization (src/pmf.h:33)
    eps: float = 1e-3                      # -e; inert unless early_stop is set
    #: Opt-in convergence stop (OFF = reference parity: the reference parses
    #: -e but never consumes it, src/pmf.h:32). When set, training ends once
    #: an outer iteration improves test RMSE by less than eps relative.
    early_stop: bool = False
    do_predict: bool = False               # -p; forces verbose (parity)
    verbose: bool = False                  # -q
    do_nmf: bool = False                   # -N; nonnegative CCD++ (libpmf semantics)
    threads: int = 4                       # -n; no-op here, kept for parity

    # --- runtime knobs (replace nBlocks/nThreadsPerBlock) ---
    backend: Backend = Backend.AUTO
    golden: bool = False                   # run REF too and golden_compare
    seed: int = 0                          # factor init seed (reference: srand(0))
    residual_dtype: str = "float32"        # dense CCD residual dtype ("bfloat16" ok)
    #: Outer iterations fused into one device dispatch. Fusing amortizes the
    #: per-dispatch host cost. Per-iteration RMSE is still computed (on
    #: device) and reported — only live per-iteration wall-timing coarsens.
    fused_outer_iters: int = 1
    #: Phase-split telemetry mode (CCD dense/ell, single device): dispatch
    #: each rank's add-back / sweeps / subtract as separate fenced device
    #: calls so the iteration line's rank_time/update_time split carries real
    #: measurements (the reference's per-phase timers, src/CCD.cpp:76-139).
    #: Slower than the fused default — the point is attribution, not speed.
    #: With ``verbose`` it also prints per-rank residual RMSE (the
    #: reference's commented calrmse_r1 path, src/CCD.cpp:141-148).
    phase_timing: bool = False
    ell_min_width: int = 8                 # narrowest ELL bucket width (pow2)
    #: ALS bucket floor. Wide buckets keep the gram einsums dense; CCD keeps
    #: ell_min_width (gather-bound, pays for padding directly). "auto" (the
    #: default): each side picks the largest floor in {128..8} that pads
    #: <= 1.3x that side's true nnz (data/ell.py auto_min_width) — 128 at
    #: ml20M (pads 1.12x), 16-32 at wide geometries like yahoo-r1, whose
    #: average user degree of 59 would pad 4.5x under a fixed 128 floor.
    als_min_width: int | str = "auto"
    #: hybrid stair orientation. False = the classic
    #: stair (panels over top-USERS x item prefixes). True = plan and run
    #: on the TRANSPOSED matrix (panels over top-items x user prefixes) —
    #: covers more nnz at equal budget when the item marginal is flatter
    #: than the user marginal (yahoo-c15: 1M x 625k, 42.2% tail under the
    #: classic stair). "auto" = geometry-plan BOTH orientations and keep
    #: the one with the smaller uncovered tail (costs one extra plan pass,
    #: no device work). Transposed runs seed the ITEM side and sweep users
    #: first — the same CCD++ family on R^T; golden parity is against the
    #: reference run on the transposed problem. Single-device hybrid only.
    hybrid_transpose: bool | str = False
    #: per-group device-memory temp budget (MB) for the grouped ALS gram
    #: assembly + solve (solvers/als_ell._row_groups): bounds the
    #: materialized augmented gather and gram per lax.map group. Huge
    #: low-degree sides (yahoo-r1 rows: 1.9M slots) split into several
    #: groups.
    als_group_mb: int = 2048
    #: gather tiling threshold (MB). An ALS side whose OTHER side's factor
    #: table exceeds this gathers per <= threshold-sized table tile
    #: (solvers/als_ell.build_side_gather_tiles; p==1 buckets), so each
    #: gather reads from a table that stays cache-resident. 0 disables.
    #: Single-device ALS only.
    als_gather_tile_mb: float = 32
    #: ALS gram-assembly matmul precision. "highest" = true f32 — the
    #: golden-grade default. "high" and "default" let the backend use
    #: reduced-precision matmul passes (TF32 on NVIDIA cards), which drift
    #: from the golden solver; kept for experiments.
    als_precision: str = "highest"
    #: k×k solve: "lax" (batched Cholesky + two triangular solves; XLA
    #: calls cuSOLVER/cuBLAS on the GPU) or "gj_xla" (pivot-free
    #: Gauss-Jordan as k full-batch broadcast FMA steps).
    als_solver: str = "lax"
    ell_chunk: int = 512                   # ALS gram scan chunk along the width axis
    eval_chunk: int = 1 << 20              # test-RMSE gather chunk
    dense_max_cells: int = 2_000_000_000   # AUTO picks DENSE below this m*n
    #: Hybrid backend: TOTAL cell budget for the dense panel stair (top
    #: users x all items, next users x top-w items, ...). Default 2e9 cells
    #: ≈ 12 GB at f32 residual + bf16 mask; conservative on an 80 GB card
    #: (ROADMAP: re-tune from measurement).
    hybrid_dense_cells: int = 2_000_000_000
    #: Widths (top-item counts) of the secondary dense panels; the first
    #: panel always spans all items. The planner grid-searches the user
    #: boundaries per width to maximize covered nnz under the cell budget.
    #: The string "auto" (the default) chooses widths AND boundaries
    #: jointly from the degree distribution (Lagrangian stair search,
    #: solvers/ccd_hybrid._auto_stair); at Netflix-100M dims and the
    #: default budget it covers far more nnz than a fixed hand stair.
    #: Tuples remain for explicit control and parity tests.
    hybrid_panel_widths: tuple = "auto"
    #: Max distinct panel widths the auto stair may emit (each panel adds a
    #: scatter program + a kernel call set per rank to the traced program).
    hybrid_max_panels: int = 8
    #: Panel mask storage dtype: "bfloat16" (default), "int8", or "nan".
    #: {0,1} is exact in bfloat16/int8, so numerics are identical; int8
    #: halves the mask's device footprint, which buys a larger panel
    #: budget. "nan" stores NO mask array at all: unobserved panel cells
    #: hold a NaN sentinel in the residual itself (NaN + delta = NaN keeps
    #: them inert through updates; sweeps read the mask as isnan(Rd)
    #: in-register), cutting panel storage to residual-only — a bf16
    #: residual fits a 6.5e9-cell stair (~97% Netflix-100M coverage) in
    #: 13 GB with bit-exact {0,1} mask numerics.
    mask_dtype: str = "bfloat16"
    #: Run the hybrid backend's dense-panel passes through the fused Pallas
    #: kernels (ops/panel_pallas.py, Triton route): update + v-sweep
    #: partials in ONE read-modify-write pass, u-sweep partials in ONE read
    #: pass. Requires mask_dtype="nan" (the kernels derive the mask from
    #: the NaN sentinel in-register).
    hybrid_panel_kernel: bool = False
    #: Rank-deferral group G for the hybrid ELL tail (0 = off, the
    #: default): residual lanes stay frozen for G ranks, sweeps run as
    #: (2G+1)-wide single-fusion gather-reduces with algebraic corrections,
    #: lanes flushed once per group (ops/ell_ops.deferred_sweep/
    #: deferred_flush). Opt-in experiment; not measured on the GPU yet.
    hybrid_defer_group: int = 0

    # --- io ---
    data_dir: Optional[str] = None         # positional data_dir (reference CLI)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0              # 0 = off; else every N outer iters
    metrics_file: Optional[str] = None     # JSONL metrics sink

    def __post_init__(self) -> None:
        self.solver = Solver(self.solver)
        self.backend = Backend(self.backend)
        if self.do_predict:
            self.verbose = True            # src/extras.cpp:130-132
        if self.k <= 0:
            raise ValueError("rank k must be positive")
        if self.maxiter < 0 or self.maxinneriter <= 0:
            raise ValueError("iteration counts must be positive")
        if self.ell_min_width & (self.ell_min_width - 1):
            raise ValueError("ell_min_width must be a power of two")
        if isinstance(self.als_min_width, str):
            if self.als_min_width != "auto":
                raise ValueError("als_min_width must be 'auto' or a power "
                                 f"of two, got {self.als_min_width!r}")
        elif self.als_min_width & (self.als_min_width - 1):
            raise ValueError("als_min_width must be 'auto' or a power of two")
        if self.als_group_mb <= 0:
            raise ValueError("als_group_mb must be positive")
        if self.als_gather_tile_mb < 0:
            raise ValueError("als_gather_tile_mb must be >= 0 (0 disables)")
        if self.hybrid_transpose not in (False, True, "auto"):
            raise ValueError("hybrid_transpose must be False, True or "
                             f"'auto', got {self.hybrid_transpose!r}")
        if self.ell_chunk < 128 or (self.ell_chunk & (self.ell_chunk - 1)):
            raise ValueError("ell_chunk must be a power of two >= 128 (it "
                             "must divide every ELL bucket width)")
        if self.als_solver not in ("gj_xla", "lax"):
            raise ValueError(f"als_solver must be 'lax' or 'gj_xla', "
                             f"got {self.als_solver!r}")
        if self.als_precision not in ("highest", "high", "default"):
            raise ValueError(f"als_precision must be 'highest', 'high' or "
                             f"'default', got {self.als_precision!r}")
        if self.residual_dtype not in ("float32", "bfloat16",
                                       "float8_e4m3fn"):
            raise ValueError(f"residual_dtype must be 'float32', 'bfloat16' "
                             f"or 'float8_e4m3fn', got "
                             f"{self.residual_dtype!r}")
        if self.mask_dtype not in ("bfloat16", "int8", "nan"):
            raise ValueError(f"mask_dtype must be 'bfloat16', 'int8' or "
                             f"'nan', got {self.mask_dtype!r}")
        if self.hybrid_panel_kernel and self.mask_dtype != "nan":
            raise ValueError("hybrid_panel_kernel requires mask_dtype='nan' "
                             "(the fused kernels read the mask from the "
                             "NaN sentinel)")
        if isinstance(self.hybrid_panel_widths, str):
            if self.hybrid_panel_widths != "auto":
                raise ValueError("hybrid_panel_widths must be a width tuple "
                                 f"or 'auto', got "
                                 f"{self.hybrid_panel_widths!r}")
        else:
            self.hybrid_panel_widths = tuple(
                int(w) for w in self.hybrid_panel_widths)
            if any(w <= 0 for w in self.hybrid_panel_widths):
                raise ValueError("hybrid_panel_widths must be positive")
        if self.hybrid_defer_group < 0:
            raise ValueError("hybrid_defer_group must be >= 0")
        if self.hybrid_max_panels <= 0:
            raise ValueError("hybrid_max_panels must be positive")

    def resolve_backend(self, m: int, n: int) -> Backend:
        """AUTO resolution: dense residual for CCD when it fits; for larger
        matrices the panel-hybrid path (single-device or sharded — the
        sharded variant row-splits every panel and the ELL tail across the
        mesh).

        ALS has exactly one compiled path (ELL): an explicit ``dense``
        request normalizes to ELL here so that logs, metrics and
        checkpoint manifests always record the backend that actually ran
        (previously the trainer dispatched ELL while reporting the requested
        name). HYBRID is CCD-only, so it normalizes too."""
        if self.backend != Backend.AUTO:
            if (self.solver == Solver.ALS
                    and self.backend in (Backend.DENSE, Backend.HYBRID)):
                return Backend.ELL
            return self.backend
        if self.solver != Solver.CCD:
            return Backend.ELL
        if m * n <= self.dense_max_cells:
            return Backend.DENSE
        if self.hybrid_dense_cells // max(1, n) > 0:
            return Backend.HYBRID
        return Backend.ELL
