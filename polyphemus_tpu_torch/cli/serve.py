"""Generation server CLI.

    python -m polyphemus_tpu_torch.cli.serve MODEL_DIR [--host 127.0.0.1]
        [--port 8000] [--batch_cap 256] [--tiers 1 8 64 256] [--no_warmup]
        [--no_coalesce] [--device cuda]

MODEL_DIR is a model directory of the JAX package (`checkpoint.msgpack`),
of the reference (`checkpoint` + `configuration`) or of the port
(`checkpoint.pt`). The server runs on the CUDA device unless `--device cpu`
is given. See polyphemus_tpu_torch/serve.py for the API.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Polyphemus generation server")
    p.add_argument("model_dir", type=str)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_cap", type=int, default=256)
    p.add_argument("--tiers", type=int, nargs="+", default=None,
                   help="batch tiers; requests route to the smallest tier "
                        ">= n. Default: 1 8 64 batch_cap")
    p.add_argument("--no_warmup", action="store_true", default=False)
    p.add_argument("--no_coalesce", action="store_true", default=False,
                   help="disable concurrent-request micro-batching")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    from ..serve import serve

    httpd, svc = serve(args.model_dir, host=args.host, port=args.port,
                       batch_cap=args.batch_cap, warmup=not args.no_warmup,
                       tiers=args.tiers, coalesce=not args.no_coalesce,
                       device=args.device)
    print(f"Serving {args.model_dir} (d={svc.mc.d}, n_bars={svc.mc.n_bars}, "
          f"batch_cap={svc.batch_cap}, tiers={svc.tiers}, "
          f"device={svc.device}) on "
          f"http://{args.host}:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
