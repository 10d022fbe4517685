#!/usr/bin/env python3
"""Seconds of bench.py's Friesian transform chain (chip_smoke.py's
``recsys_transforms`` over ``recsys_raw_df``) at a given size, by mode
and tier, on the host (no card needed).

    python3 dev/time_friesian_chain.py [--rows 200000] [--users 6040]
        [--items 3706] [--mode vectorized|legacy] [TIER ...]

TIERs are ``DRAM`` (default), ``DISK_n`` or ``NATIVE_n``; each runs the
chain once from the same seeded frame and prints its seconds.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.common.context import OrcaContext

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--users", type=int, default=cs.ML1M_USERS)
    ap.add_argument("--items", type=int, default=cs.ML1M_ITEMS)
    ap.add_argument("--mode", choices=("vectorized", "legacy"),
                    default="vectorized")
    ap.add_argument("tiers", nargs="*", default=["DRAM"])
    args = ap.parse_args()
    if args.mode == "legacy":
        os.environ.update(ZOO_DATA_VECTORIZE="0", ZOO_DATA_WORKERS="0")
    df = cs.recsys_raw_df(args.rows, args.users, args.items)
    for tier in args.tiers:
        OrcaContext.train_data_store = tier
        t0 = time.perf_counter()
        cs.recsys_transforms(df, args.items)
        print(f"{args.mode} {tier} {args.rows} rows: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
