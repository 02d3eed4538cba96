"""Command line of the port — the `serve` verb of `shifu_tpu/cli.py`
(single model set; the registry fleet comes later).

    python -m shifu_tpu_torch --dir <model-set> serve [--port P]
        [--no-http] [--duration-s S] [--device cuda|cpu]

Serves every model spec under ``<model-set>/models`` (the
`PathFinder.models_path()` rule) until SIGTERM/SIGINT or `--duration-s`,
then prints the service stats as one JSON line. `--device` defaults to
the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
from typing import List, Optional

log = logging.getLogger("shifu_tpu_torch")


def models_path(model_set_dir: str) -> str:
    """`PathFinder.models_path()`: ``models/`` under the model-set
    root."""
    return os.path.join(os.path.abspath(model_set_dir), "models")


def cmd_serve(args) -> int:
    from shifu_tpu_torch.serve.service import ScorerService
    owner = ScorerService(models_dir=models_path(args.dir),
                          device=args.device).start()
    log.info("scorer service warm: %s", owner.stats())
    front = None
    if not args.no_http:
        from shifu_tpu_torch.serve.http import HttpFrontEnd
        front = HttpFrontEnd(owner, port=args.port).start()
        log.info("serving HTTP on %s:%d", *front.address)
    stop = threading.Event()
    previous = {sig: signal.signal(sig, lambda *_: stop.set())
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        stop.wait(args.duration_s if args.duration_s else None)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        if front is not None:
            front.close()
        owner.close()
    print(json.dumps(owner.stats()))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="shifu_tpu_torch")
    ap.add_argument("--dir", default=".", help="model-set directory")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("serve", help="low-latency scorer service")
    p.add_argument("--port", type=int, default=None,
                   help="HTTP port (default SHIFU_TPU_SERVE_PORT; "
                        "0 = ephemeral)")
    p.add_argument("--no-http", action="store_true",
                   help="in-process service only, no listener")
    p.add_argument("--duration-s", type=float, default=0.0,
                   help="exit after this many seconds (0 = run until "
                        "SIGTERM/SIGINT)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda)")
    p.set_defaults(fn=cmd_serve)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)
