"""Export a train checkpoint of the port to the reference's torch layout.

Counterpart of `camouflaged_vlm_tpu/cli/export_checkpoint.py`: reads a
checkpoint written by `cli/train.py` (`ckpt_best.pt` / `ckpt_last.pt`:
{"model", "optimizer", "step"}) and writes the `.pth` state dict the
reference's own tooling loads (`test_ovcos_maskdecoder_edge.py`
`load_state_dict`): the entries of `io/convert.cascade_key_map`, in its
order, in float32. The port's keys are the reference's, so no entry is
transformed.

    python -m camouflaged_vlm_tpu_torch.cli.export_checkpoint \\
        --checkpoint save/ovcos_torch/ckpt_best.pt --out model_best.pth \\
        [--tiny | --config c.yaml] [--strict]
"""

from __future__ import annotations

import argparse
from typing import Dict, Sequence

import torch

from ..io.convert import reference_state_dict
from .common import cascade_config, local_file


def main(argv: Sequence[str] = None) -> Dict[str, torch.Tensor]:
    """Write --out and return the exported state dict."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True, help="cli/train.py checkpoint (.pt)")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--config", default=None, help="model config yaml")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke runs)")
    p.add_argument("--strict", action="store_true",
                   help="fail if any mapped parameter is missing from the checkpoint")
    args = p.parse_args(argv)
    cfg = cascade_config(args.config, args.tiny, None)
    ckpt = torch.load(local_file(args.checkpoint, "--checkpoint"), map_location="cpu",
                      weights_only=True)
    sd, missing = reference_state_dict(ckpt["model"], cfg, strict=args.strict)
    torch.save(sd, args.out)
    print(f"wrote {args.out}: {len(sd)} tensors"
          + (f" ({len(missing)} mapped params absent: {missing[:3]}...)" if missing else ""),
          flush=True)
    return sd


if __name__ == "__main__":
    main()
