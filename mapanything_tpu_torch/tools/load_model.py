"""Build the flagship (or the small) MapAnything of the port and load weights.

    python3 -m mapanything_tpu_torch.tools.load_model [--checkpoint <hub dir | .pth | .pt>]
        [--trusted-checkpoint] [--save <hub dir>] [--small] [--device cuda]

The port of ``scripts/load_model.py``. ``--checkpoint`` is a directory that
``utils.hub.save_pretrained`` wrote (``config.json`` + ``model.pt``), or a
reference-format checkpoint (``utils.checkpoint``: ``module.`` prefixes and
``dense_head.0/.1`` aliases allowed; a file with the six geometric encoders
builds the model with ``geometric_inputs=True``; one that holds more than
tensors loads only with ``--trusted-checkpoint``). Prints the parameter count.
Without ``--checkpoint`` and ``--save`` the model is built on the meta device
(no memory, no weights): the images-only flagship has 500,050,174 parameters.
``--save`` writes a hub directory.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from mapanything_tpu_torch.models.mapanything import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.utils.checkpoint import load_reference_state_dict, model_from_reference
from mapanything_tpu_torch.utils.hub import from_pretrained, save_pretrained


def load_model(
    checkpoint: Optional[str] = None,
    small: bool = False,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trusted: bool = False,
    **overrides,
) -> Tuple[MapAnything, str]:
    """``(model, source)``: the model of a hub directory, or the flagship (or
    small) config with ``overrides`` loaded from a reference checkpoint file
    (unpickled in full only if ``trusted``), or seeded random weights without
    ``checkpoint``. ``source`` is "hub", "checkpoint" or "random"."""
    if checkpoint is not None and (Path(checkpoint) / "config.json").is_file():
        return from_pretrained(checkpoint, device, **overrides), "hub"
    cfg = MapAnythingConfig.small(**overrides) if small else MapAnythingConfig(**overrides)
    if checkpoint is None:
        return MapAnything(cfg, device=device, seed=seed), "random"
    return model_from_reference(cfg, load_reference_state_dict(checkpoint, trusted), device), "checkpoint"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None, help="hub directory, or a .pth/.pt reference checkpoint")
    ap.add_argument("--trusted-checkpoint", action="store_true",
                    help="unpickle a checkpoint that holds more than tensors (can run code: trusted files only)")
    ap.add_argument("--save", default=None, help="write the model to this hub directory")
    ap.add_argument("--small", action="store_true", help="MapAnythingConfig.small()")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.checkpoint is None and args.save is None:
        cfg = MapAnythingConfig.small() if args.small else MapAnythingConfig()
        with torch.device("meta"):
            model = MapAnything(cfg, device="meta")
        print("counted on the meta device (no weights)")
    else:
        model, source = load_model(args.checkpoint, args.small, args.device, trusted=args.trusted_checkpoint)
        print(f"loaded {source} weights" + (f" from {args.checkpoint}" if args.checkpoint else " (seeded random)"))
    print(f"model: {type(model).__name__}, {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters")
    if args.save:
        print(f"saved to {save_pretrained(model, args.save)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
