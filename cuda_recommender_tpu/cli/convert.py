"""Dataset converter CLI: text ratings -> reference packed binary layout.

The replacement for the reference's offline preconversion step (its
loaders expect preconverted binaries, /root/reference/src/tools.cpp:3-85, but
the converter itself is not in that repo). Reads MovieLens-style text
(``user item rating [ts]``), splits train/test, and writes a
``meta_modified_all`` directory any reference-compatible consumer can load.
Uses the native C++ text parser (cuda_recommender_tpu/native) when built,
falling back to NumPy.
"""

from __future__ import annotations

import argparse
import sys

from ..data import binfmt, datasets
from ..data.sparse import from_coo, make_test


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cuda_recommender_tpu.cli.convert")
    p.add_argument("input", help="text ratings file (user item rating [ts])")
    p.add_argument("output_dir", help="destination dataset directory")
    p.add_argument("--test-fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zero-based", action="store_true",
                   help="ids in the input are 0-based (default 1-based)")
    args = p.parse_args(argv)

    try:
        from ..native import textparse
        r, c, v = textparse.load_text_ratings(args.input,
                                              one_based=not args.zero_based)
        print("[info] parsed with native C++ parser", flush=True)
    except (ImportError, OSError):
        r, c, v = datasets.load_text_ratings(args.input,
                                             one_based=not args.zero_based)
        print("[info] parsed with NumPy fallback", flush=True)

    rows = int(r.max()) + 1 if len(r) else 0
    cols = int(c.max()) + 1 if len(c) else 0
    if args.test_fraction > 0:
        R, T = datasets.train_test_split_coo(
            rows, cols, r, c, v, test_fraction=args.test_fraction,
            seed=args.seed)
    else:
        R = from_coo(rows, cols, r, c, v)
        T = make_test(rows, cols, [], [], [])
    binfmt.write_binary_dataset(args.output_dir, R, T)
    print(f"[info] wrote {args.output_dir}: {R.rows} x {R.cols} "
          f"nnz={R.nnz} test={T.nnz}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
