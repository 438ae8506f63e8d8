"""Process entry point: config → cluster node → sync → HTTP server.

Parity reference: main.go — load config, boot cluster node, serve RPC,
startup sync, run HTTP server, graceful SIGTERM shutdown (main.go:40-98).

Usage: ``python -m semadb_tpu.main [--config path.yaml]`` or set
``SEMADB_CONFIG``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="semadb_tpu server")
    parser.add_argument("--config", default="", help="YAML config path (or SEMADB_CONFIG)")
    args = parser.parse_args(argv)

    from semadb_tpu.cluster.node import ClusterNode
    from semadb_tpu.cluster.sync import sync
    from semadb_tpu.httpapi.server import run_http_server
    from semadb_tpu.utils.compilecache import configure as configure_compile_cache
    from semadb_tpu.utils.config import load_config

    # One persistent compile cache across server restarts: the grow-ahead's
    # AOT warm-up (IndexIVF.warm_capacity_shapes) lands there.
    configure_compile_cache()
    cfg = load_config(args.config)
    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    log = logging.getLogger("semadb")
    log.info("starting semadb_tpu node")

    node = ClusterNode(cfg.cluster_node)
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
    stop.wait()
    http_server.shutdown()
    node.close()
    log.info("shutdown complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
