"""Live inference demo: upload images in a browser -> metric 3D viewer.

    python3 -m mapanything_tpu_torch.tools.live_demo [--checkpoint <hub dir | .pth | .pt>]
        [--trusted-checkpoint] [--port 8008] [--small] [--device cuda]

The port of ``scripts/live_demo.py``: the flagship in bf16 (or, with
``--small``, ``MapAnythingConfig.small()``) with seeded random weights, or
``--checkpoint`` through ``tools.load_model`` (``utils/hub.py`` /
``utils/checkpoint.py``), served by ``utils.live_server`` on ``--port`` (0:
a free one). The model runs on ``--device``, CUDA unless it names another.
"""

from __future__ import annotations

import argparse

from mapanything_tpu_torch.tools.load_model import load_model
from mapanything_tpu_torch.utils.live_server import make_model_infer_fn, make_server


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None, help="hub directory, or a .pth/.pt reference checkpoint")
    ap.add_argument("--trusted-checkpoint", action="store_true",
                    help="unpickle a checkpoint that holds more than tensors (can run code: trusted files only)")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--small", action="store_true", help="test-scale model (MapAnythingConfig.small())")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_server(args: argparse.Namespace, model=None):
    """The bound server of ``args`` around ``model`` (built from the flags when None)."""
    if model is None:
        overrides = {} if args.small else {"compute_dtype": "bfloat16"}
        model, source = load_model(args.checkpoint, small=args.small, device=args.device,
                                   trusted=args.trusted_checkpoint, **overrides)
        if source == "random":
            print("no --checkpoint: serving RANDOM weights (structure demo)")
    return make_server(make_model_infer_fn(model), port=args.port, host=args.host)


def main(argv=None) -> int:
    args = parse_args(argv)
    srv = build_server(args)
    print(f"live demo at http://localhost:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
