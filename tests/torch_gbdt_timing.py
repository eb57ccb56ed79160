"""Fit time of the port's histogram GBDT against scikit-learn's on one host.

    python tests/torch_gbdt_timing.py [--rows 9216] [--reps 3]

Both fit the same 9,216 rows (the full default predictor window less its
1,024-row holdout; ``tests/test_predictor.py``'s synthetic world) with the
reference's parameters, in turns: scikit-learn with its OpenMP threads, the
port's, scikit-learn on one thread. Prints one JSON line: each fit's
seconds, the host's CPU count and the largest relative difference of the two
fits' predictions. Needs scikit-learn and threadpoolctl (not the port)."""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
from sklearn.ensemble import HistGradientBoostingRegressor as SkRegressor
from threadpoolctl import threadpool_limits

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from llmd_tpu_torch.predictor.gbdt import HistGradientBoostingRegressor  # noqa: E402

KW = dict(max_iter=100, max_depth=6, learning_rate=0.1, min_samples_leaf=4)


def world(rng, n):
    X = np.column_stack([rng.uniform(0, 1, n), rng.integers(16, 2048, n),
                         rng.integers(0, 20, n), rng.integers(0, 16, n),
                         rng.uniform(0, 1, n), rng.integers(0, 4096, n)]).astype(float)
    y = (0.4 * X[:, 1] * (1 - X[:, 4]) + 80 * X[:, 2] + 300 * np.maximum(0, X[:, 0] - 0.7)
         + 10) * rng.normal(1, 0.02, n)
    return X, y


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=9216)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    X, y = world(np.random.default_rng(0), args.rows)
    times = {"sklearn": [], "port": [], "sklearn_1_thread": []}
    diff = 0.0
    for _ in range(args.reps):
        t0 = time.perf_counter()
        sk = SkRegressor(**KW).fit(X, y)
        times["sklearn"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ours = HistGradientBoostingRegressor(**KW).fit(X, y)
        times["port"].append(time.perf_counter() - t0)
        with threadpool_limits(1):
            t0 = time.perf_counter()
            SkRegressor(**KW).fit(X, y)
            times["sklearn_1_thread"].append(time.perf_counter() - t0)
        a, b = sk.predict(X), ours.predict(X)
        diff = max(diff, float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12))))
    print(json.dumps({"rows": args.rows, "cpus": os.cpu_count(), "seconds": times,
                      "max_rel_diff": diff}))


if __name__ == "__main__":
    main()
