"""Command line of the port — the `serve` and `train` verbs of
`shifu_tpu/cli.py` (single model set; the registry fleet comes later).

    python -m shifu_tpu_torch --dir <model-set> serve [--port P]
        [--no-http] [--duration-s S] [--device cuda|cpu]
    python -m shifu_tpu_torch --dir <model-set> train [--device cuda|cpu]

`serve` serves every model spec under ``<model-set>/models`` (the
`PathFinder.models_path()` rule) until SIGTERM/SIGINT or `--duration-s`,
then prints the service stats as one JSON line. `train` trains the
model set's GBT/RF/DT algorithm from `tmp/CleanedData` into
``models/model<bag>.{gbt,rf}`` and prints one JSON line: the algorithm,
the device, the wall seconds and the launches of each training kernel
during the run. `--device` defaults to the card and raises when there
is none.
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


def cmd_train(args) -> int:
    import time

    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.ops import best_splits, level_hist
    from shifu_tpu_torch.processor import train as train_proc
    from shifu_tpu_torch.processor.base import ProcessorContext
    def counts():
        return {"level_hist": level_hist.launches,
                "level_hist_fused": level_hist.fused_launches,
                "best_splits": best_splits.launches}

    dev = resolve_device(args.device)
    ctx = ProcessorContext.load(os.path.abspath(args.dir))
    before = counts()
    t0 = time.perf_counter()
    rc = train_proc.run(ctx, device=dev)
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    print(json.dumps({
        "algorithm": ctx.model_config.train.algorithm.value,
        "device": str(dev), "seconds": time.perf_counter() - t0,
        "launches": {k: v - before[k] for k, v in counts().items()}}))
    return rc


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
    p = sub.add_parser("train", help="train the model set's GBT/RF/DT "
                                     "algorithm")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    p.set_defaults(fn=cmd_train)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)
