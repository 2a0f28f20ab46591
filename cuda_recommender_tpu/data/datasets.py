"""Dataset generation and text loaders.

The reference ships no data, only binary loaders for pre-converted MovieLens /
Netflix / Yahoo dumps (/root/reference/src/tools.cpp:3-85) and a bench sweep over
them (scripts/times.sh). Since no datasets are bundled here either, this module
provides (a) reproducible synthetic rating matrices — uniform and power-law
("zipf") to model the real datasets' degree skew — and (b) a MovieLens-style text
parser (``user item rating [ts]`` per line) for real data.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .sparse import RatingMatrix, TestCOO, from_coo, make_test

#: fixed in-checkout directory for synthetic_cached (listed in .gitignore)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".cache", "datasets")



def synthetic(m: int, n: int, nnz: int, *, k_true: int = 8, noise: float = 0.1,
              test_fraction: float = 0.1, seed: int = 0,
              power_law: bool = True) -> tuple[RatingMatrix, TestCOO]:
    """Low-rank-plus-noise rating matrix with optional power-law degrees.

    Ratings come from a rank-``k_true`` ground truth so RMSE convergence curves
    are meaningful (they should drop well below the rating std).
    """
    rng = np.random.default_rng(seed)
    target = int(nnz / (1.0 - test_fraction)) if test_fraction > 0 else nnz
    target = min(target, m * n)

    if power_law:
        # Zipf-ish marginals over users and items, like MovieLens/Netflix;
        # inverse-CDF sampling (cumsum + searchsorted) scales to 100M+ draws.
        cu = np.cumsum(1.0 / np.arange(1, m + 1) ** 0.8)
        ci = np.cumsum(1.0 / np.arange(1, n + 1) ** 0.9)
        cu /= cu[-1]
        ci /= ci[-1]

        def draw(size):
            return (np.searchsorted(cu, rng.random(size)).astype(np.int64),
                    np.searchsorted(ci, rng.random(size)).astype(np.int64))
    else:
        def draw(size):
            return (rng.integers(0, m, size=size).astype(np.int64),
                    rng.integers(0, n, size=size).astype(np.int64))

    # dedupe on packed keys; overdraw once, top up if collisions ran heavy
    keys = np.empty(0, np.int64)
    for _ in range(6):
        need = target - keys.shape[0]
        if need <= 0:
            break
        du, di = draw(int(need * 1.7) + 16)
        keys = np.unique(np.concatenate([keys, du * n + di]))
    # unique() sorts — shuffle so truncation doesn't bias toward low ids
    keys = keys[rng.permutation(keys.shape[0])][:target]
    ui, ii = keys // n, keys % n
    total = ui.shape[0]

    W = rng.normal(0, 1.0 / np.sqrt(k_true), size=(m, k_true)).astype(np.float32)
    H = rng.normal(0, 1.0 / np.sqrt(k_true), size=(n, k_true)).astype(np.float32)
    vals = np.einsum("ek,ek->e", W[ui], H[ii]) + 3.5
    vals += rng.normal(0, noise, size=total)
    vals = vals.astype(np.float32)

    perm = rng.permutation(total)
    n_test = int(total * test_fraction)
    te, tr = perm[:n_test], perm[n_test:]

    R = from_coo(m, n, ui[tr], ii[tr], vals[tr])
    T = make_test(m, n, ui[te], ii[te], vals[te])
    return R, T


def _zipf_cdf(size: int, exponent: float) -> np.ndarray:
    c = np.cumsum(1.0 / np.arange(1, size + 1) ** exponent)
    return (c / c[-1]).astype(np.float32)


def synthetic_device(m: int, n: int, nnz: int, *, k_true: int = 8,
                     noise: float = 0.1, test_fraction: float = 0.1,
                     seed: int = 0) -> tuple[RatingMatrix, TestCOO]:
    """``synthetic()``'s power-law matrix with the heavy work on the default
    JAX device: the inverse-CDF draws, the de-duplication (a two-key sort),
    the random subset and the low-rank ratings. Same distribution as
    synthetic() (zipf marginals, rank-``k_true`` ratings + noise, a random
    test split); another draw for the same seed. The host only builds the
    CSR/CSC containers. Made for 100M-rating matrices, whose host-side
    NumPy generation takes minutes."""
    import jax
    import jax.numpy as jnp

    target = int(nnz / (1.0 - test_fraction)) if test_fraction > 0 else nnz
    target = min(target, m * n)
    cu, ci = jnp.asarray(_zipf_cdf(m, 0.8)), jnp.asarray(_zipf_cdf(n, 0.9))

    @functools.partial(jax.jit, static_argnums=1)
    def draw(key, size):
        ku, ki = jax.random.split(key)
        u = jnp.searchsorted(cu, jax.random.uniform(ku, (size,)))
        i = jnp.searchsorted(ci, jax.random.uniform(ki, (size,)))
        return (jnp.minimum(u, m - 1).astype(jnp.int32),
                jnp.minimum(i, n - 1).astype(jnp.int32))

    @jax.jit
    def first_of_runs(u, i):                 # sort pairs, flag first copies
        u, i = jax.lax.sort((u, i), num_keys=2)
        new = jnp.concatenate([jnp.ones(1, bool),
                               (u[1:] != u[:-1]) | (i[1:] != i[:-1])])
        return u, i, new

    @functools.partial(jax.jit, static_argnums=3)
    def compact(u, i, new, count):
        at = jnp.nonzero(new, size=count)[0]
        return u[at], i[at]

    key = jax.random.PRNGKey(seed)
    u = i = jnp.zeros(0, jnp.int32)
    for _ in range(6):                       # overdraw, top up if needed
        need = target - u.shape[0]
        if need <= 0:
            break
        key, kd = jax.random.split(key)
        du, di = draw(kd, int(need * 1.7) + 16)
        u, i, new = first_of_runs(jnp.concatenate([u, du]),
                                  jnp.concatenate([i, di]))
        u, i = compact(u, i, new, int(new.sum()))

    @functools.partial(jax.jit, static_argnums=3)
    def rate(key, u, i, total):
        kp, kw, kh, kn = jax.random.split(key, 4)
        # a random subset of ``total`` pairs, in random order
        _, u, i = jax.lax.sort((jax.random.uniform(kp, u.shape), u, i),
                               num_keys=1)
        u, i = u[:total], i[:total]
        sd = 1.0 / np.sqrt(k_true)
        W = sd * jax.random.normal(kw, (m, k_true))
        H = sd * jax.random.normal(kh, (n, k_true))
        v = (W[u] * H[i]).sum(-1) + 3.5 + noise * jax.random.normal(
            kn, (total,))
        return u, i, v

    total = min(target, u.shape[0])
    u, i, v = (np.asarray(x) for x in rate(key, u, i, total))
    n_test = int(total * test_fraction)
    R = from_coo(m, n, u[n_test:], i[n_test:], v[n_test:])
    T = make_test(m, n, u[:n_test], i[:n_test], v[:n_test])
    return R, T


def synthetic_cached(m: int, n: int, nnz: int, *, seed: int = 0,
                     test_fraction: float = 0.1,
                     cache_dir: str | None = None
                     ) -> tuple[RatingMatrix, TestCOO]:
    """Disk-cached ``synthetic()``: generating a 100M-rating Zipf matrix
    takes a minute or more, so runs that train on the same matrix more than
    once share one deterministic on-disk instance keyed by (m, n, nnz,
    seed), under ``cache_dir`` (default CACHE_DIR)."""
    cache_dir = cache_dir or CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"crtpu_synth_{m}_{n}_{nnz}_s{seed}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return (from_coo(m, n, z["ri"], z["ci"], z["vv"]),
                make_test(m, n, z["ti"], z["tj"], z["tv"]))
    R, T = synthetic(m=m, n=n, nnz=nnz, seed=seed,
                     test_fraction=test_fraction)
    ri, ci, vv = R.to_coo()
    with open(path + ".tmp", "wb") as f:
        np.savez(f, ri=ri, ci=ci, vv=vv, ti=T.row_idx, tj=T.col_idx,
                 tv=T.val)
    os.replace(path + ".tmp", path)        # atomic publish
    return R, T


def ml1m_like(seed: int = 0, *, test_fraction: float = 0.1
              ) -> tuple[RatingMatrix, TestCOO]:
    """Deterministic MovieLens-1M-calibrated fixture (no network access to
    fetch the real dump).

    Matches ml-1m's published marginals: 6040 users x 3706 rated movies,
    ~1.0M ratings, integer ratings 1..5 with mean ≈ 3.58, doubly power-law
    degree distributions. Ratings follow a user-bias + item-bias + low-rank
    + noise model rounded to the 1..5 grid, so MF test RMSE converges into
    the ~0.85-0.95 band real ml-1m runs produce (the noise floor is the
    irreducible eps + rounding variance) instead of the synthetic()
    fixture's ~0.2-0.4.
    """
    m, n, target = 6040, 3706, 1_000_209
    rng = np.random.default_rng(seed)

    cu = np.cumsum(1.0 / np.arange(1, m + 1) ** 0.75)
    ci = np.cumsum(1.0 / np.arange(1, n + 1) ** 0.95)
    cu /= cu[-1]
    ci /= ci[-1]

    keys = np.empty(0, np.int64)
    for _ in range(8):
        need = target - keys.shape[0]
        if need <= 0:
            break
        du = np.searchsorted(cu, rng.random(int(need * 1.8) + 16))
        di = np.searchsorted(ci, rng.random(int(need * 1.8) + 16))
        keys = np.unique(np.concatenate([keys, du * n + di]))
    keys = keys[rng.permutation(keys.shape[0])][:target]
    ui, ii = (keys // n).astype(np.int64), (keys % n).astype(np.int64)
    total = ui.shape[0]

    k_true = 12
    mu = 3.58
    bu = rng.normal(0.0, 0.45, size=m)
    bi = rng.normal(0.0, 0.50, size=n)
    U = rng.normal(0, np.sqrt(0.45 / k_true), size=(m, k_true))
    V = rng.normal(0, np.sqrt(0.45 / k_true), size=(n, k_true))
    raw = (mu + bu[ui] + bi[ii] + np.einsum("ek,ek->e", U[ui], V[ii])
           + rng.normal(0, 0.65, size=total))
    vals = np.clip(np.rint(raw), 1.0, 5.0).astype(np.float32)

    perm = rng.permutation(total)
    n_test = int(total * test_fraction)
    te, tr = perm[:n_test], perm[n_test:]
    R = from_coo(m, n, ui[tr], ii[tr], vals[tr])
    T = make_test(m, n, ui[te], ii[te], vals[te])
    return R, T


def parse_synthetic_spec(spec: str) -> dict:
    """Parse 'synthetic:m=1000,n=200,nnz=20000,seed=0' CLI dataset specs."""
    out: dict = {}
    body = spec.split(":", 1)[1] if ":" in spec else ""
    for part in filter(None, body.split(",")):
        key, val = part.split("=")
        out[key] = float(val) if "." in val else int(val)
    return out


def synthetic_from_spec(spec: str) -> tuple[RatingMatrix, TestCOO]:
    """One-call CLI helper: spec string -> dataset, with float-valued knobs
    (noise, test_fraction) kept as floats and counts as ints."""
    kw = parse_synthetic_spec(spec)
    float_keys = {"noise", "test_fraction"}
    kw = {k: (float(v) if k in float_keys else int(v)) for k, v in kw.items()}
    if kw.pop("cache", 0):
        # ``cache=1`` routes through the disk cache (synthetic_cached) so
        # repeated sweep invocations at 100M+ nnz don't regenerate for
        # minutes each; only the cached signature's knobs are allowed.
        extra = set(kw) - {"m", "n", "nnz", "seed", "test_fraction"}
        if extra:
            raise ValueError(f"cache=1 spec does not support {sorted(extra)}")
        return synthetic_cached(**kw)
    return synthetic(**kw)


def load_text_ratings(path: str, *, one_based: bool = True) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse 'user item rating [...]' text lines (MovieLens ML-style, also the
    reference's text test-file format at src/pmf_util.h:155-168)."""
    data = np.loadtxt(path, usecols=(0, 1, 2), dtype=np.float64, ndmin=2)
    r = data[:, 0].astype(np.int64)
    c = data[:, 1].astype(np.int64)
    if one_based:
        r -= 1
        c -= 1
    return r, c, data[:, 2].astype(np.float32)


def train_test_split_coo(rows: int, cols: int, r, c, v, *, test_fraction: float = 0.1,
                         seed: int = 0) -> tuple[RatingMatrix, TestCOO]:
    rng = np.random.default_rng(seed)
    n_total = len(v)
    perm = rng.permutation(n_total)
    n_test = int(n_total * test_fraction)
    te, tr = perm[:n_test], perm[n_test:]
    return (from_coo(rows, cols, r[tr], c[tr], v[tr]),
            make_test(rows, cols, r[te], c[te], v[te]))
