"""Serving daemon entry: put a bundle behind HTTP.

Port of ``mme_tpu/cli/serve.py``. Serves on the card::

    python -m mme_tpu_torch.cli.serve --bundle runs/bundle --port 8000
    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/predict -d '{"instances": [...]}'

and on the CPU only through ``main(argv, device="cpu")`` (with a bundle
exported on the CPU). The bundle is the directory ``run_classifier`` writes
under ``MME_EXPORT_BUNDLE`` (``serve.py::export_bundle``: a
``torch.export`` program with its weights; no model code at serve time).
``--port 0`` binds a free port; the line printed at start names it.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from mme_tpu_torch.device import DeviceLike


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> None:
    p = argparse.ArgumentParser("mme_tpu_torch serving daemon")
    p.add_argument("--bundle", required=True,
                   help="export_bundle directory (MME_EXPORT_BUNDLE)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)

    from mme_tpu_torch.serve_http import serve_bundle
    server = serve_bundle(args.bundle, args.host, args.port, device=device)
    host, port = server.server_address[:2]
    print(f"serving {args.bundle} on http://{host}:{port} "
          "(POST /predict, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
