"""Process entry point: config → cluster node → sync → HTTP server.

Port of ``semadb_tpu/main.py``. Parity reference: main.go — load config,
boot cluster node, serve RPC, startup sync, run HTTP server, graceful
SIGTERM shutdown (main.go:40-98).

Usage: ``python -m semadb_tpu_torch.main [--config path.yaml]
[--device cuda]`` or set ``SEMADB_CONFIG``. The device defaults to
``cuda``; a CUDA device that is not available is an error, never a silent
move to the CPU. At shutdown the node logs how many times it launched each
hand-written kernel (``kernel launches: {...}``).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="semadb_tpu_torch server")
    parser.add_argument("--config", default="", help="YAML config path (or SEMADB_CONFIG)")
    parser.add_argument("--device", default="cuda", help="torch device for the indices")
    args = parser.parse_args(argv)

    import torch

    from semadb_tpu_torch.cluster.node import ClusterNode
    from semadb_tpu_torch.cluster.sync import sync
    from semadb_tpu_torch.httpapi.server import run_http_server
    from semadb_tpu_torch.ops.kernels import launch_counts
    from semadb_tpu_torch.utils.config import load_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    cfg = load_config(args.config)
    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    log = logging.getLogger("semadb")
    log.info("starting semadb_tpu_torch node on %s", device)

    node = ClusterNode(cfg.cluster_node, device)
    node.serve()
    log.info("rpc serving on %s", node.my_hostname)
    stats = sync(node)
    log.info("startup sync: %s", stats)

    http_server = run_http_server(node, cfg.http_api)
    log.info("http serving on port %d", http_server.port)

    stop = threading.Event()

    def on_signal(signum, frame):
        log.info("signal %s received, shutting down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    # Timed waits: the handler runs in this thread, and a set() that lands
    # inside an untimed wait before it sleeps would not wake it
    while not stop.wait(1.0):
        pass
    http_server.shutdown()
    node.close()
    log.info("kernel launches: %s", launch_counts())
    log.info("shutdown complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
