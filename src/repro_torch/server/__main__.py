"""``python -m repro_torch.server`` — run the pool service from the shell.

Prints ``repro-server listening on http://HOST:PORT`` (flushed) once the
socket is bound, so harnesses that pass ``--port 0`` can parse the
ephemeral port. SIGTERM/SIGINT shut down gracefully: in-flight verbs
finish, journals are flushed and closed.
"""
from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from .http import PoolHTTPServer
from .service import ExperimentConfig, PoolService


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-server",
        description="NodIO-style multi-experiment pool service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8040,
                   help="0 = ephemeral (parse the startup line)")
    p.add_argument("--spool", default=None,
                   help="spool directory for WAL journals + configs "
                        "(default: in-memory, no durability)")
    p.add_argument("--resume", action="store_true",
                   help="rehydrate experiments from the spool's WALs")
    # default-experiment config knobs
    p.add_argument("--capacity", type=int, default=1024,
                   help="pool capacity per shard")
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--acceptance", default="always")
    p.add_argument("--epsilon", type=float, default=0.0)
    # frontend knobs
    p.add_argument("--rate", type=float, default=200.0,
                   help="per-client token bucket refill (req/s)")
    p.add_argument("--burst", type=float, default=400.0)
    p.add_argument("--max-queue", type=int, default=512,
                   help="backpressure threshold (queued pool verbs)")
    p.add_argument("--executor-workers", type=int, default=1)
    return p


async def _amain(args: argparse.Namespace) -> int:
    config = ExperimentConfig.from_json({
        "capacity": args.capacity, "shards": args.shards, "seed": args.seed,
        "acceptance": args.acceptance, "epsilon": args.epsilon})
    service = PoolService(spool_dir=args.spool, resume=args.resume,
                          default_config=config)
    server = PoolHTTPServer(
        service, host=args.host, port=args.port, rate=args.rate,
        burst=args.burst, max_queue=args.max_queue,
        executor_workers=args.executor_workers)
    await server.start()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, server.stop)
    print(f"repro-server listening on {server.url}", flush=True)
    await server.serve_forever()
    await server.aclose()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return asyncio.run(_amain(args))
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
