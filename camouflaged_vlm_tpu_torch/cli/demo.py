"""Single-image cascade demo on the GPU.

Counterpart of `camouflaged_vlm_tpu/cli/demo.py`: preprocess one image, run
the cascade (stage-1 mask + stage-2 open-vocabulary class), and write a
green overlay named `[<predicted class>]<input name>` and the mask as
`mask_<input stem>.png`.

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.demo --image scorpionfish.jpg \
      --out-dir ./demo_out --cascade-ckpt model_epoch_best.pth \
      [--clip-ckpt ViT-L-14-336px.pt --text-bank TestCamoPromptsTextFeatures.pth]

The checkpoint flags (`cli/common.py`: `--sam-ckpt`, `--clip-ckpt`,
`--maple-ckpt`, `--cascade-ckpt`, `--text-bank`) take the reference's
files; the weights no file sets are random (seeded by `--seed`), so without
them the class is arbitrary. `--device cuda` on a machine without a GPU
raises, and so does float32 on the card where the configuration's path has a
kernel with no fp32 instance (`common.refuse_fp32_on_card`: the tiny
configuration's unfused SAM blocks, #10; the full one runs fp32 on the card,
TF32 off); the demo never carries on on the CPU unless `--device cpu` asks
for it.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Sequence

import numpy as np
import torch
from PIL import Image

from ..config import DTYPES
from ..data import native
from ..data import native_pipeline as npp
from ..data.ovcamo import TEST_CLASS_NAMES
from ..data.transforms import clip_image_transform, clip_ones_alpha, sam_image_transform
from ..factory import attach_rel_cache, build_full_cascade, build_tiny_cascade
from ..utils.image import bilinear_resize_f32
from .common import (
    add_checkpoint_flags,
    cascade_config,
    device_or_raise,
    exact_fp32_on_card,
    load_checkpoints,
    preproc_line,
    refuse_fp32_on_card,
)


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
    add_checkpoint_flags(p)
    args = p.parse_args(argv)
    if not os.path.exists(args.image):
        p.error(f"--image {args.image!r} does not exist")
    return args


class DemoSession:
    """The model, its class split, the split's class bank and its encoded
    text features."""

    def __init__(self, args: argparse.Namespace):
        cfg = cascade_config(None, args.tiny, args.dtype)
        refuse_fp32_on_card(args.device, cfg)
        device = device_or_raise(args.device)
        exact_fp32_on_card(args.device, cfg)
        build = build_tiny_cascade if args.tiny else build_full_cascade
        self.model, cfg = build(DTYPES[args.dtype], device, args.seed)
        self.classnames: List[str] = (
            args.classnames.split(",") if args.classnames else list(TEST_CLASS_NAMES)
        )
        self.cfg, self.device = cfg, device
        make_bank = load_checkpoints(
            self.model, cfg, clip_ckpt=args.clip_ckpt, maple_ckpt=args.maple_ckpt,
            sam_ckpt=args.sam_ckpt, cascade_ckpt=args.cascade_ckpt, seed=args.seed)
        attach_rel_cache(self.model)  # after the weights are final
        self.bank = make_bank(self.classnames, args.text_bank)
        self.text_features = self.model.encode_class_text_features(
            self.bank["prefix"], self.bank["suffix"], self.bank["eot_indices"],
            self.bank["bank_features"])

    def preprocess(self, images: Sequence):
        """PIL images, or RGB uint8 arrays (`load_image`'s native decode)
        through the native transforms: the same values."""
        cfg, dev = self.cfg, self.device
        nat = [isinstance(im, np.ndarray) for im in images]
        inp = np.stack([(npp.sam_image_transform if n else sam_image_transform)(im, cfg.inp_size)
                        for im, n in zip(images, nat)])
        cimg = np.stack([(npp.clip_image_transform if n else clip_image_transform)(
            im, cfg.clip_size) for im, n in zip(images, nat)])
        cmask = np.stack([clip_ones_alpha(cfg.clip_size) for _ in images])
        return tuple(torch.from_numpy(a).to(dev) for a in (inp, cimg, cmask))

    def predict(self, images: Sequence):
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


def load_image(path: str):
    """The image as an RGB uint8 array, decoded natively unless
    CVLM_NATIVE_PREPROC=0 or its container is one the decoder does not take
    (then a PIL image, as the JAX demo loads it)."""
    if native.enabled():
        arr = native.decode_file(path, 3)
        if arr is not None:
            return arr
        print("[demo] host preprocessing: the image's container is not one the native "
              "decoder takes: PIL decodes it", flush=True)
    return Image.open(path).convert("RGB")


def main(argv: Sequence[str] = None) -> None:
    args = parse_args(argv)
    print(preproc_line("demo"), flush=True)
    session = DemoSession(args)
    img = load_image(args.image)
    probs, pred, _ = session.predict([img])
    cls = session.classnames[int(pred[0])]
    print(f"predicted class: {cls}", flush=True)
    out_path, mask_path = write_outputs(args.image, np.asarray(img), probs[0], cls, args.out_dir)
    print(f"wrote {out_path} and {mask_path}", flush=True)


if __name__ == "__main__":
    main()
