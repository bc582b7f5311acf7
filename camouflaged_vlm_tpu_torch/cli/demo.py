"""Single-image cascade demo on the GPU.

Counterpart of `camouflaged_vlm_tpu/cli/demo.py`: preprocess one image, run
the cascade (stage-1 mask + stage-2 open-vocabulary class), and write a
green overlay named `[<predicted class>]<input name>` and the mask as
`mask_<input stem>.png`.

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.demo --image scorpionfish.jpg \
      --out-dir ./demo_out [--cascade-ckpt model_epoch_best.pth]

Without `--cascade-ckpt` the weights are random (seeded by `--seed`), so the
class is arbitrary. `--device cuda` on a machine without a GPU raises; the
demo never carries on on the CPU unless `--device cpu` asks for it.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Sequence

import numpy as np
import torch
from PIL import Image

from camouflaged_vlm_tpu.data.ovcamo import TEST_CLASS_NAMES
from camouflaged_vlm_tpu.data.transforms import (
    clip_image_transform,
    clip_ones_alpha,
    sam_image_transform,
)
from camouflaged_vlm_tpu.utils.image import bilinear_resize_f32

from ..factory import (
    attach_rel_cache,
    build_full_cascade,
    build_tiny_cascade,
    make_bank_inputs,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def overlay_mask(image: np.ndarray, mask01: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Green overlay where mask > 0.5 (uint8 HWC in, uint8 HWC out)."""
    out = image.astype(np.float32).copy()
    sel = mask01 > 0.5
    out[sel] = (1 - alpha) * out[sel] + alpha * np.array([0.0, 255.0, 0.0], np.float32)
    return out.astype(np.uint8)


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image", required=True)
    p.add_argument("--out-dir", default="./demo_out")
    p.add_argument("--classnames", default=None,
                   help="comma-separated; default the OVCamo test split (61 classes)")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cascade-ckpt", default=None,
                   help="reference-layout cascade state dict (.pth), loaded strict")
    args = p.parse_args(argv)
    if not os.path.exists(args.image):
        p.error(f"--image {args.image!r} does not exist")
    return args


class DemoSession:
    """The model, its class split and the split's encoded text features."""

    def __init__(self, args: argparse.Namespace):
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        build = build_tiny_cascade if args.tiny else build_full_cascade
        self.model, cfg = build(DTYPES[args.dtype], device, args.seed)
        self.classnames: List[str] = (
            args.classnames.split(",") if args.classnames else list(TEST_CLASS_NAMES)
        )
        self.cfg, self.device = cfg, device
        if args.cascade_ckpt:
            sd = torch.load(args.cascade_ckpt, map_location=device, weights_only=True)
            self.model.load_state_dict(sd.get("model", sd), strict=True)
        attach_rel_cache(self.model)  # after the weights are final
        bank = make_bank_inputs(cfg, self.classnames, seed=args.seed, device=device)
        self.text_features = self.model.encode_class_text_features(
            bank["prefix"], bank["suffix"], bank["eot_indices"], bank["bank_features"]
        )

    def preprocess(self, images: Sequence[Image.Image]):
        cfg, dev = self.cfg, self.device
        inp = np.stack([sam_image_transform(im, cfg.inp_size) for im in images])
        cimg = np.stack([clip_image_transform(im, cfg.clip_size) for im in images])
        cmask = np.stack([clip_ones_alpha(cfg.clip_size) for _ in images])
        return tuple(torch.from_numpy(a).to(dev) for a in (inp, cimg, cmask))

    def predict(self, images: Sequence[Image.Image]):
        """-> (mask probabilities (B, H, W) fp32 numpy, class ids (B,), logits (B, N))."""
        probs, pred, logits = self.model.infer_cascade_with_text(
            *self.preprocess(images), self.text_features
        )
        return probs[..., 0].cpu().numpy(), pred.cpu().numpy(), logits.float().cpu().numpy()


def write_outputs(image_path: str, orig: np.ndarray, probs: np.ndarray, cls: str,
                  out_dir: str):
    """Resize the mask to the original size (float first, then truncating
    quantisation, the reference demo's order) and write overlay + mask."""
    mask01 = (
        (bilinear_resize_f32(probs, orig.shape[0], orig.shape[1]) * 255)
        .astype(np.uint8).astype(np.float32) / 255.0
    )
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.basename(image_path)
    out_path = os.path.join(out_dir, f"[{cls}]{name}")
    Image.fromarray(overlay_mask(orig, mask01)).save(out_path)
    mask_path = os.path.join(out_dir, f"mask_{os.path.splitext(name)[0]}.png")
    Image.fromarray((mask01 * 255).astype(np.uint8)).save(mask_path)
    return out_path, mask_path


def main(argv: Sequence[str] = None) -> None:
    args = parse_args(argv)
    session = DemoSession(args)
    img = Image.open(args.image).convert("RGB")
    probs, pred, _ = session.predict([img])
    cls = session.classnames[int(pred[0])]
    print(f"predicted class: {cls}", flush=True)
    out_path, mask_path = write_outputs(args.image, np.asarray(img), probs[0], cls, args.out_dir)
    print(f"wrote {out_path} and {mask_path}", flush=True)


if __name__ == "__main__":
    main()
