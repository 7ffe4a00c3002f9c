"""``python -m tsspark_tpu_torch.serve.replica`` — one pool replica process.

Spawned by ``serve.pool.ReplicaPool`` (not an operator entry point):
claims its slot lease, attaches a full ``PredictionEngine`` over the
shared registry, and serves the JSONL envelope on its unix socket until
killed, told to quit, or fenced out of its lease.  Lives outside
``serve/__init__`` imports so runpy executes it without the
found-in-sys.modules double-import warning.

One departure from the JAX package's replica, which pins itself to the
CPU unless ``TSSPARK_SERVE_DEVICE`` says otherwise: the port's entry
points run on the card unless the caller asks for the CPU.  So a replica
serves on ``cuda`` by default, and on the CPU only with ``--device cpu``
(or ``TSSPARK_SERVE_DEVICE=cpu``); without a card and without that
request it fails loudly at start instead of serving the plain versions
(a card replica also loads the kernel library before serving, and exits
with ``pool.RC_NO_LIBRARY`` when it cannot).  Before anything loads
the kernel library, the replica arms the kernel bank named by
``$TSSPARK_AOT_CACHE_DIR`` (``serve/aotbank.py``), so a cold replica
loads the library built at publish time instead of building it.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tsspark_tpu_torch.serve.replica",
        description="serve replica-pool worker",
    )
    ap.add_argument("--pool-dir", required=True)
    ap.add_argument("--slot", type=int, required=True)
    ap.add_argument("--registry", required=True)
    ap.add_argument("--socket", required=True)
    ap.add_argument("--gen", type=int, default=1)
    ap.add_argument("--heartbeat-s", type=float, default=0.25)
    ap.add_argument("--lease-ttl-s", type=float, default=1.5)
    ap.add_argument("--max-queue", type=int, default=4096)
    ap.add_argument("--max-batch", type=int, default=128)
    # None defers to the configured default
    # ($TSSPARK_SERVE_CACHE_CAPACITY -> serve.cache.default_capacity).
    ap.add_argument("--cache-capacity", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; $TSSPARK_SERVE_DEVICE "
                    "when the flag is absent")
    args = ap.parse_args(argv)
    device = args.device or os.environ.get("TSSPARK_SERVE_DEVICE") or None

    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.serve import aotbank
    from tsspark_tpu_torch.serve.pool import run_replica

    obs.adopt_env()
    bank = aotbank.arm_from_env()
    return run_replica(
        args.pool_dir, args.slot, args.registry, args.socket,
        gen=args.gen, heartbeat_s=args.heartbeat_s,
        lease_ttl_s=args.lease_ttl_s, max_queue=args.max_queue,
        max_batch=args.max_batch, cache_capacity=args.cache_capacity,
        device=device, bank=bank,
    )


if __name__ == "__main__":
    sys.exit(main())
