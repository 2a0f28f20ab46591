"""Ranking metrics for the retrieval path (recall/precision/hit-rate/NDCG).

No counterpart exists in the reference (its eval is RMSE-only,
/root/reference/src/tools.cpp:235-248); these back the MIPS serving
harness (recall@10 of retrieved items, cli/bench_serve.py).
"""

from __future__ import annotations

import numpy as np


def _per_user(retrieved: np.ndarray, relevant) -> list[tuple[np.ndarray, np.ndarray]]:
    out = []
    for b, rel in enumerate(relevant):
        rel = np.asarray(rel)
        got = retrieved[b]
        got = got[got >= 0]
        out.append((got, rel))
    return out


def recall_at_k(retrieved: np.ndarray, relevant) -> float:
    acc, users = 0.0, 0
    for got, rel in _per_user(retrieved, relevant):
        if rel.size == 0:
            continue
        users += 1
        acc += np.isin(rel, got).sum() / rel.size
    return acc / max(1, users)


def precision_at_k(retrieved: np.ndarray, relevant) -> float:
    acc, users = 0.0, 0
    for got, rel in _per_user(retrieved, relevant):
        if rel.size == 0 or got.size == 0:
            continue
        users += 1
        acc += np.isin(got, rel).sum() / got.size
    return acc / max(1, users)


def hit_rate_at_k(retrieved: np.ndarray, relevant) -> float:
    hits, users = 0, 0
    for got, rel in _per_user(retrieved, relevant):
        if rel.size == 0:
            continue
        users += 1
        hits += bool(np.isin(rel, got).any())
    return hits / max(1, users)


def ndcg_at_k(retrieved: np.ndarray, relevant) -> float:
    """Binary-relevance NDCG@k."""
    acc, users = 0.0, 0
    for got, rel in _per_user(retrieved, relevant):
        if rel.size == 0:
            continue
        users += 1
        gains = np.isin(got, rel).astype(np.float64)
        discounts = 1.0 / np.log2(np.arange(2, got.size + 2))
        dcg = float(gains @ discounts)
        ideal = float(discounts[:min(rel.size, got.size)].sum())
        acc += dcg / ideal if ideal > 0 else 0.0
    return acc / max(1, users)
