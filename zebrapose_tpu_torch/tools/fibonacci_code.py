"""Fibonacci-sphere code-assignment experiment.

The port's copy of `zebrapose_tpu/tools/fibonacci_code.py`, itself a
re-creation of the reference's standalone study (`zebrapose/
fibonacci_sphere.py:7-76`): sample points quasi-uniformly on a sphere,
assign each an n-bit code, and simulated-anneal code swaps to minimize
the Hamming distance between spatially adjacent points (a locality-
preserving alternative to hierarchical partitioning; no command runs
it). numpy only; equal to the JAX package's at the same seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def fibonacci_sphere(n: int) -> np.ndarray:
    """[n, 3] quasi-uniform unit-sphere samples (golden-angle spiral):
    the reference's formula (fibonacci_sphere.py:7-18), z = 1 - 2i/(n-1)
    (poles included), theta = golden-angle * i."""
    i = np.arange(n, dtype=np.float64)
    theta = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / (n - 1)
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)


def locality_cost(codes: np.ndarray, neighbors: np.ndarray) -> float:
    """Mean Hamming distance over the neighbor pairs."""
    a = codes[neighbors[:, 0]]
    b = codes[neighbors[:, 1]]
    return float(np.mean(np.sum(a != b, axis=1)))


def _knn_pairs(pts: np.ndarray, k: int = 6) -> np.ndarray:
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1)[:, :k]
    i = np.repeat(np.arange(len(pts)), k)
    return np.stack([i, nn.reshape(-1)], axis=1)


def anneal_code_assignment(pts: np.ndarray, n_bits: int,
                           iterations: int = 20000, t0: float = 2.0,
                           seed: int = 0
                           ) -> Tuple[np.ndarray, float, float]:
    """Assign each point an n_bits code; anneal pairwise swaps to improve
    spatial Hamming locality. Returns (codes [N, n_bits], initial cost,
    final cost)."""
    n = len(pts)
    if n > 2 ** n_bits:
        raise ValueError("more points than codes")
    rng = np.random.default_rng(seed)
    ids = rng.permutation(2 ** n_bits)[:n]
    codes = ((ids[:, None] >> np.arange(n_bits - 1, -1, -1)) & 1).astype(
        np.int8)
    neighbors = _knn_pairs(pts)
    # adjacency list for incremental cost evaluation
    adj = [[] for _ in range(n)]
    for a, b in neighbors:
        adj[a].append(b)

    def local_cost(i, code_i):
        return sum(int(np.sum(code_i != codes[j])) for j in adj[i])

    c0 = locality_cost(codes, neighbors)
    for it in range(iterations):
        t = t0 * (1.0 - it / iterations) + 1e-6
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        before = local_cost(i, codes[i]) + local_cost(j, codes[j])
        after = local_cost(i, codes[j]) + local_cost(j, codes[i])
        delta = after - before
        if delta < 0 or rng.random() < np.exp(-delta / t):
            codes[[i, j]] = codes[[j, i]]
    return codes, c0, locality_cost(codes, neighbors)
