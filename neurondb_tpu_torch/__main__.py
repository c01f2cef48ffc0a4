"""CLI — `python -m neurondb_tpu_torch <command>`.

Service entry points matching the reference's binaries (neurondb-mcp,
agent-server) plus engine utilities; the counterpart of
``neurondb_tpu/__main__.py``. ``devices`` lists the CUDA devices by name
and fails when there is none (it never reports the CPU).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(prog="neurondb_tpu_torch",
                                description="CUDA-native vector search + ML")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("mcp", help="MCP stdio JSON-RPC server")

    sp = sub.add_parser("rest", help="REST agent/search server")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8080)

    sp = sub.add_parser("metrics", help="Prometheus exporter")
    sp.add_argument("--port", type=int, default=None)

    sub.add_parser("config", help="show effective configuration")

    sub.add_parser("algorithms", help="list ML algorithms")

    sub.add_parser("devices", help="show the CUDA devices")

    args = p.parse_args(argv)

    if args.cmd == "mcp":
        from neurondb_tpu_torch.service.mcp import MCPServer
        MCPServer().serve_stdio()
    elif args.cmd == "rest":
        import time
        from neurondb_tpu_torch.service.rest import RESTServer
        srv = RESTServer(host=args.host, port=args.port)
        port = srv.start()
        print(f"REST server on {args.host}:{port}", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.stop()
    elif args.cmd == "metrics":
        import time
        from neurondb_tpu_torch.service.metrics import PrometheusExporter
        exp = PrometheusExporter(port=args.port)
        port = exp.start()
        print(f"Prometheus exporter on :{port}/metrics", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            exp.stop()
    elif args.cmd == "config":
        from neurondb_tpu_torch.config import get_config
        print(json.dumps(get_config().as_dict(), indent=2))
    elif args.cmd == "algorithms":
        from neurondb_tpu_torch.ml.api import list_algorithms
        print("\n".join(list_algorithms()))
    elif args.cmd == "devices":
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                             "False)")
        for i in range(n):
            print(f"cuda:{i} {torch.cuda.get_device_name(i)}")


if __name__ == "__main__":
    main()
