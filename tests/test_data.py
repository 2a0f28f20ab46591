"""Data-layer tests: COO/CSR/CSC containers and the ELL layout invariants."""

import numpy as np
import pytest

from cuda_recommender_tpu.data import datasets
from cuda_recommender_tpu.data.ell import build_ell_pair
from cuda_recommender_tpu.data.sparse import from_coo


def test_from_coo_roundtrip():
    r = [0, 2, 1, 2, 0]
    c = [1, 0, 3, 2, 0]
    v = [1.0, 2.0, 3.0, 4.0, 5.0]
    R = from_coo(3, 4, r, c, v)
    dense = np.zeros((3, 4), np.float32)
    dense[r, c] = v
    np.testing.assert_array_equal(R.to_dense(), dense)
    # transpose view
    np.testing.assert_array_equal(R.transpose().to_dense(), dense.T)
    assert R.nnz == 5
    assert R.max_row_nnz == 2
    np.testing.assert_array_equal(R.col_nnz, [2, 1, 1, 1])


def test_from_coo_sorted_ptrs(small_data):
    R, T = small_data
    assert R.csr_ptr[0] == 0 and R.csr_ptr[-1] == R.nnz
    assert R.csc_ptr[0] == 0 and R.csc_ptr[-1] == R.nnz
    # csr rows sorted
    rows = np.repeat(np.arange(R.rows), np.diff(R.csr_ptr))
    assert (np.diff(rows) >= 0).all()


@pytest.mark.parametrize("num_shards", [1, 4])
def test_ell_pair_reconstructs_matrix(small_data, num_shards):
    R, _ = small_data
    pair = build_ell_pair(R, num_shards=num_shards)
    dense = R.to_dense()

    for side, other, ax_dense in ((pair.cols_side, pair.rows_side, dense.T),
                                  (pair.rows_side, pair.cols_side, dense)):
        assert side.other_zero_slot == other.n_slots
        # every entity has a slot; maps are inverse
        assert (side.slot_of_entity >= 0).all()
        ent = side.entity_of_slot
        valid = ent >= 0
        np.testing.assert_array_equal(
            side.slot_of_entity[ent[valid]], np.where(valid)[0])
        # per-slot nnz matches degrees
        deg = (ax_dense != 0).sum(axis=1)
        np.testing.assert_array_equal(side.slot_nnz[side.slot_of_entity], deg)

        # reconstruct the dense matrix from buckets
        rec = np.zeros_like(ax_dense)
        other_entity_of_slot = other.entity_of_slot
        for b, boff in zip(side.buckets, side.bucket_offsets):
            for rr in range(b.rows):
                shard = rr // b.rows_per_shard
                local_r = rr % b.rows_per_shard
                for j in range(b.p):
                    slot = (shard * side.slots_per_shard + boff
                            + local_r * b.p + j)
                    e = side.entity_of_slot[slot]
                    seg_idx = b.idx[rr, j * b.E:(j + 1) * b.E]
                    seg_val = b.val[rr, j * b.E:(j + 1) * b.E]
                    real = seg_idx != side.other_zero_slot
                    if e < 0:
                        assert not real.any()
                        continue
                    oe = other_entity_of_slot[seg_idx[real]]
                    rec[e, oe] += seg_val[real]
                    # padding vals are zero
                    assert (seg_val[~real] == 0).all()
        np.testing.assert_allclose(rec, ax_dense, rtol=1e-6)


def test_ell_shard_uniformity(small_data):
    R, _ = small_data
    pair = build_ell_pair(R, num_shards=4)
    for side in (pair.rows_side, pair.cols_side):
        assert side.n_slots == 4 * side.slots_per_shard
        for b in side.buckets:
            assert b.rows == 4 * b.rows_per_shard
            assert b.idx.shape == b.val.shape
            assert b.idx.shape[1] == b.E * b.p   # L = p*E, all lanes slot-owned
            assert b.E * b.p <= 128 or b.p == 1


def test_ell_padding_bounded(small_data):
    R, _ = small_data
    pair = build_ell_pair(R)
    for side in (pair.rows_side, pair.cols_side):
        # data-driven ladder: never worse than the 2x pow2 bound
        slack = sum(b.p * b.E for b in side.buckets) * 8  # row-padding bound
        assert side.nnz_padded <= 2 * pair.nnz + slack


def test_ell_width_ladder_optimality():
    """The DP ladder (data/ell.py _choose_widths) must not exceed the
    power-of-two ladder's padding, and each entity's bucket width must
    cover its degree (floored at min_width)."""
    from cuda_recommender_tpu.data.ell import _choose_widths, _plan_buckets
    rng = np.random.default_rng(7)
    deg = rng.zipf(1.7, size=4000).clip(max=5000).astype(np.int64)
    deg[rng.integers(0, 4000, 50)] = 0                 # some empty entities
    min_width = 8
    eff = np.maximum(deg[deg > 0], min_width)
    ladder = _choose_widths(eff, max_buckets=12)
    assert ladder.size <= 12 and int(ladder[-1]) == int(eff.max())
    cost = ladder[np.searchsorted(ladder, eff)].sum()
    pow2 = np.asarray([1 << b for b in range(3, 14)])
    cost_pow2 = pow2[np.searchsorted(pow2, eff)].sum()
    assert cost <= cost_pow2
    plan, empty = _plan_buckets(deg, min_width)
    assert empty.size == int((deg == 0).sum())
    covered = np.concatenate([ids for _, ids in plan])
    assert sorted(covered) == sorted(np.where(deg > 0)[0])
    for E, ids in plan:
        assert (np.maximum(deg[ids], min_width) <= E).all()


def test_ell_width_ladder_edge_cases():
    from cuda_recommender_tpu.data.ell import _choose_widths
    # all-equal degrees -> a single exact width
    lad = _choose_widths(np.full(100, 37, np.int64), max_buckets=8)
    assert lad.tolist() == [37]
    # a single entity
    assert _choose_widths(np.asarray([9], np.int64), 8).tolist() == [9]
    # fewer unique degrees than buckets -> every width exact (zero padding)
    eff = np.asarray([8, 8, 12, 50, 50, 50, 1000], np.int64)
    lad = _choose_widths(eff, max_buckets=8)
    assert lad.tolist() == [8, 12, 50, 1000]
    # huge spread with subsampled candidates still covers the max
    rng = np.random.default_rng(3)
    eff = rng.integers(8, 200_000, size=20_000).astype(np.int64)
    lad = _choose_widths(eff, max_buckets=6)
    assert lad.size <= 6 and lad[-1] >= eff.max()
    assert (lad[np.searchsorted(lad, eff)] >= eff).all()


def test_synthetic_shapes():
    R, T = datasets.synthetic(m=100, n=50, nnz=1000, seed=1)
    assert R.rows == 100 and R.cols == 50
    assert T.nnz > 0
    assert R.nnz >= 800  # dedupe may drop a few, test split took 10%
    assert 1.0 < R.csr_val.mean() < 6.0


def test_spread_collect(small_data):
    R, _ = small_data
    pair = build_ell_pair(R)
    side = pair.cols_side
    x = np.arange(side.n_entities, dtype=np.float32)
    xs = side.spread(x)
    np.testing.assert_array_equal(side.collect(xs), x)


def test_ml1m_like_marginals():
    """Deterministic ml-1m-calibrated fixture: exact dims, integer ratings
    1..5 with ml-like mean, power-law degrees, bit-stable across calls."""
    import numpy as np
    from cuda_recommender_tpu.data.datasets import ml1m_like
    R, T = ml1m_like(seed=0)
    assert (R.rows, R.cols) == (6040, 3706)
    assert 0.99e6 <= R.nnz + T.nnz <= 1.01e6
    v = np.concatenate([R.csr_val, T.val])
    assert set(np.unique(v)) <= {1.0, 2.0, 3.0, 4.0, 5.0}
    assert 3.4 < v.mean() < 3.7
    # heavy degree skew like the real dataset
    d = np.sort(R.row_nnz)[::-1]
    assert d[:604].sum() > 0.3 * R.nnz          # top-10% users
    R2, T2 = ml1m_like(seed=0)
    np.testing.assert_array_equal(R.csr_val, R2.csr_val)
    np.testing.assert_array_equal(T.val, T2.val)


def test_ell_entity_index_space(small_data):
    """entity-indexed buckets reference raw entity ids (zero sentinel at
    n_entities) and reconstruct the matrix exactly: for every bucket slot,
    scatter its (idx, val) lanes into a dense row for the slot's entity."""
    import numpy as np
    from cuda_recommender_tpu.data.ell import build_ell_pair
    R, _ = small_data
    pe = build_ell_pair(R, min_width=8, index_space="entity")
    rows = pe.rows_side
    assert rows.other_zero_slot == R.cols
    dense = np.zeros((R.rows, R.cols + 1), np.float64)
    for b, off in zip(rows.buckets, rows.bucket_offsets):
        assert b.idx.max() <= R.cols              # sentinel == n_cols
        for rrow in range(b.rows):
            for j in range(b.p):
                slot = off + rrow * b.p + j
                ent = rows.entity_of_slot[slot]
                if ent < 0:
                    continue
                lanes = slice(j * b.E, (j + 1) * b.E)
                np.add.at(dense[ent], b.idx[rrow, lanes],
                          b.val[rrow, lanes])
    np.testing.assert_allclose(dense[:, :R.cols], R.to_dense(), atol=1e-5)
    assert np.all(dense[:, R.cols] == 0)          # sentinel lanes carry 0


def test_paired_gather_matches_direct_indexing():
    """paired_gather (lax.map-chunked row gathers) must equal direct fancy
    indexing, including the zero-sentinel row and non-chunk-multiple rows."""
    import jax.numpy as jnp
    import numpy as np
    from cuda_recommender_tpu.ops.ell_ops import extend_zero, paired_gather
    rng = np.random.default_rng(3)
    S = 500
    pair = rng.normal(size=(S, 2)).astype(np.float32)
    pair_ext = extend_zero(jnp.asarray(pair))         # row S == zeros
    idx_tiles = [
        jnp.asarray(rng.integers(0, S + 1, size=(37, 128)).astype(np.int32)),
        jnp.asarray(rng.integers(0, S + 1, size=(4097, 64)).astype(np.int32)),
    ]
    out = paired_gather(pair_ext, idx_tiles)
    ext = np.concatenate([pair, np.zeros((1, 2), np.float32)])
    for (a, b), ix in zip(out, idx_tiles):
        ixn = np.asarray(ix)
        np.testing.assert_array_equal(np.asarray(a), ext[ixn][..., 0])
        np.testing.assert_array_equal(np.asarray(b), ext[ixn][..., 1])


def test_synthetic_spec_cache_roundtrip(tmp_path, monkeypatch):
    """cache=1 specs route through the disk cache and reproduce the direct
    synthetic() dataset for the same knobs; non-cacheable knobs are rejected."""
    import numpy as np
    import pytest
    from cuda_recommender_tpu.data import datasets

    # point the cache at tmp_path so the test never touches /tmp state
    orig = datasets.synthetic_cached

    def cached_tmp(*a, **kw):
        kw.setdefault("cache_dir", str(tmp_path))
        return orig(*a, **kw)

    monkeypatch.setattr(datasets, "synthetic_cached", cached_tmp)
    spec = "synthetic:m=60,n=40,nnz=300,seed=3,test_fraction=0.1,cache=1"
    R1, T1 = datasets.synthetic_from_spec(spec)
    R2, T2 = datasets.synthetic_from_spec(spec)       # second call: from disk
    np.testing.assert_array_equal(R1.csr_val, R2.csr_val)
    np.testing.assert_array_equal(T1.val, T2.val)
    Rd, _ = datasets.synthetic(m=60, n=40, nnz=300, seed=3, test_fraction=0.1)
    np.testing.assert_array_equal(R1.csr_val, Rd.csr_val)

    with pytest.raises(ValueError, match="cache=1"):
        datasets.synthetic_from_spec("synthetic:m=6,n=4,nnz=3,noise=0.5,cache=1")


def test_auto_min_width_degree_adaptive():
    """auto_min_width: keeps the wide 128 floor when
    degrees support it (ml20M-like, avg ~144) and drops to a narrow floor
    on wide low-degree geometries (yahoo-r1-like, avg ~59 zipf), bounding
    padded lanes at <= 1.3x nnz by construction."""
    from cuda_recommender_tpu.data.ell import AUTO_FLOOR_TAU, auto_min_width
    rng = np.random.default_rng(3)
    heavy = rng.zipf(1.35, size=20_000).clip(max=30_000).astype(np.int64)
    heavy = heavy[heavy >= 40] + 100          # avg well above 128
    assert auto_min_width(heavy) == 128
    light = rng.zipf(1.6, size=50_000).clip(max=20_000).astype(np.int64)
    w = auto_min_width(light)                 # heavy tail of 1s and 2s
    assert w < 128
    pad = np.maximum(light[light > 0], w).sum()
    assert pad <= AUTO_FLOOR_TAU * light[light > 0].sum()
    assert auto_min_width(np.zeros(5, np.int64)) == 8


def test_build_ell_pair_auto_floor_per_side():
    """min_width='auto' resolves per side from that side's degrees and the
    layout stays consistent (fill invariants hold, golden zero-slot rules
    intact)."""
    from cuda_recommender_tpu.data.ell import build_ell_pair
    rng = np.random.default_rng(5)
    m, n, nnz = 800, 40, 12_000               # jester-shaped: tiny n
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    key = rows.astype(np.int64) * n + cols
    _, uniq = np.unique(key, return_index=True)
    R = from_coo(m, n, rows[uniq], cols[uniq], vals[uniq])
    pair = build_ell_pair(R, min_width="auto")
    # users side: avg degree ~ nnz/m ~ 15 -> narrow floor; items side:
    # avg degree ~ nnz/n ~ 300 -> keeps the wide floor
    assert min(b.E for b in pair.rows_side.buckets) < 128
    assert min(b.E for b in pair.cols_side.buckets) >= 128
    # padded lanes within the tau bound on the constrained side
    lanes = sum(b.idx.size for b in pair.rows_side.buckets)
    assert lanes <= 1.3 * R.nnz + sum(
        b.p * b.E * 8 for b in pair.rows_side.buckets)


@pytest.mark.parametrize("m,n,nnz,tf", [(300, 120, 6000, 0.1),
                                        (400, 300, 5000, 0.0),
                                        (1000, 500, 20_000, 0.2)])
def test_synthetic_device_matches_contract(m, n, nnz, tf):
    """The on-device generator: unique ratings up to nnz (and m*n) — like
    synthetic(), six rounds of draws may leave a dense skewed matrix short,
    so these sparse shapes allow 5% — a disjoint test split of the requested fraction, ratings
    around the rank-8 + 3.5 model, deterministic per seed."""
    target = min(int(nnz / (1 - tf)) if tf else nnz, m * n)
    R, T = datasets.synthetic_device(m, n, nnz, test_fraction=tf, seed=5)
    total = R.nnz + T.nnz
    assert R.rows == m and R.cols == n
    assert 0.95 * target <= total <= target
    assert T.nnz == int(total * tf)
    r, c, v = R.to_coo()
    train_keys = r.astype(np.int64) * n + c
    test_keys = T.row_idx.astype(np.int64) * n + T.col_idx
    assert np.unique(train_keys).size == R.nnz
    assert not np.intersect1d(train_keys, test_keys).size
    assert abs(float(v.mean()) - 3.5) < 0.2
    R2, T2 = datasets.synthetic_device(m, n, nnz, test_fraction=tf, seed=5)
    np.testing.assert_array_equal(R.csr_idx, R2.csr_idx)
    np.testing.assert_array_equal(T.val, T2.val)

