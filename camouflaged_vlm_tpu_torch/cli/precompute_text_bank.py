"""Precompute a frozen per-class text-feature bank on the GPU.

Counterpart of `camouflaged_vlm_tpu/cli/precompute_text_bank.py` (the
reference's prompt-bank builder, `cocotrainers/alphaCLIP.py:148-223`): for
each class name, embed its templated prompts with the PLAIN CLIP text tower
(no MaPLe prompts), L2-normalise each, average, renormalise; the result,
(num_classes, 768), is the bank the cascade adds to its learned text
features (the shipped `{Train,Test}CamoPromptsTextFeatures*.pth`).

The tower is the JAX CLI's, `AlphaClipConfig.vit_l_14_336()`, in float32:
on the card its MLPs run the fp32 instance of the LN+MLP+residual kernel
(TPU kernels #4/#5, `csrc/ln_mlp_residual_f32.cu`), its causal attention
plain PyTorch, as the JAX tower's. Each class's prompts are encoded as they
are, in one call; the JAX CLI pads their count to a power of two only to
limit XLA's compiled shapes, and the rows are independent.

Usage:
  python -m camouflaged_vlm_tpu_torch.cli.precompute_text_bank \\
      --clip-ckpt ViT-L-14-336px.pt --split test --out test_bank.npy \\
      [--templates camoprompts,imagenet80] [--gpt-json cupl.json]

`--device cuda` (the default) on a host without a card raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..data.ovcamo import TEST_CLASS_NAMES, TRAIN_CLASS_NAMES
from ..data.templates import TEMPLATE_SETS
from ..io.convert import CLIP_TEXT, convert_openai_clip
from ..io.torch_loader import load_openai_clip_state_dict
from ..models.clip import AlphaClipConfig, ClipTextTower, tokenize
from .common import device_or_raise, local_file

# The reference's fixed ensembling order (`alphaCLIP.py:131-242`: each mode
# folds into the accumulator in this sequence); the pairwise mean chain is
# order-sensitive, so it does not follow the order of --templates.
ENSEMBLE_ORDER = ("imagenet80", "camoprompts", "__gpt__", "attributes")

Encoder = Callable[[Sequence[str]], np.ndarray]


def build_text_tower(clip_cfg: AlphaClipConfig, text_state: Dict[str, torch.Tensor],
                     device) -> ClipTextTower:
    """The text tower on `device` with `text_state` (its keys without the
    `clip_model.text_encoder.` prefix) loaded strictly."""
    with torch.device("meta"):
        tower = ClipTextTower(clip_cfg)
    tower = tower.to_empty(device=device)
    tower.load_state_dict(text_state, strict=True)
    return tower.eval().requires_grad_(False)


def make_encoder(tower: ClipTextTower, token_embedding: np.ndarray) -> Encoder:
    """prompts -> (n, embed_dim) fp32 numpy, each row L2-normalised: one
    tower call on the n prompts."""
    device = next(tower.parameters()).device
    table = torch.from_numpy(np.ascontiguousarray(token_embedding, np.float32)).to(device)

    @torch.no_grad()
    def encode_prompts(prompts: Sequence[str]) -> np.ndarray:
        if not prompts:
            raise ValueError("empty prompt list (a CuPL JSON class entry with no prompts?): "
                             "every class needs at least one prompt")
        tokens = torch.from_numpy(tokenize(list(prompts), tower.cfg.context_length)).to(device)
        feats = tower(table[tokens.long()], tokens.argmax(dim=-1), []).float().cpu().numpy()
        return feats / np.linalg.norm(feats, axis=-1, keepdims=True)

    return encode_prompts


def encode_text_features(encode_prompts: Encoder, classnames: Sequence[str],
                         templates: Sequence[str]) -> np.ndarray:
    """(num_classes, embed_dim): per class, the normalised mean of its
    templates' normalised embeddings (`alphaCLIP.py:148-163`)."""
    out = []
    for name in classnames:
        mean = encode_prompts([t.format(name) for t in templates]).mean(axis=0)
        out.append(mean / np.linalg.norm(mean))
    return np.stack(out)


def _cupl_key(name: str) -> str:
    return name.lower().replace("_", " ")


def encode_gpt_bank(encode_prompts: Encoder, classnames: Sequence[str],
                    gpt_json_path: str) -> np.ndarray:
    """The CuPL-GPT bank (`alphaCLIP.py:195-223`): each class's own prompt
    list from the JSON (keys matched lowercase, underscores as spaces), the
    mean of its normalised embeddings, rows renormalised at the end. Every
    class's key is checked before any encoding."""
    with open(gpt_json_path) as f:
        gpt = {_cupl_key(k): v for k, v in json.load(f).items()}
    missing = [n for n in classnames if _cupl_key(n) not in gpt]
    if missing:
        raise KeyError(
            f"CuPL JSON {gpt_json_path} lacks prompts for {len(missing)} classes (keys are "
            f"matched lowercase with underscores as spaces): {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}")
    bank = np.stack([encode_prompts(gpt[_cupl_key(n)]).mean(axis=0) for n in classnames])
    return bank / np.linalg.norm(bank, axis=-1, keepdims=True)


def combine_banks(banks: Sequence[np.ndarray]) -> np.ndarray:
    """The reference's cross-mode ensembling: each bank averaged pairwise
    with the accumulated one, then renormalised (`alphaCLIP.py:190-196`)."""
    acc = banks[0]
    for b in banks[1:]:
        acc = np.stack([acc, b]).mean(axis=0)
        acc = acc / np.linalg.norm(acc, axis=-1, keepdims=True)
    return acc


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clip-ckpt", required=True,
                   help="OpenAI CLIP TorchScript archive (ViT-L-14-336px.pt)")
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument("--templates", default="camoprompts",
                   help="comma-separated subset of %s, ensembled in the reference's order %s"
                   % (sorted(TEMPLATE_SETS), list(ENSEMBLE_ORDER)))
    p.add_argument("--gpt-json", default=None, help="CuPL-GPT per-class prompts JSON")
    p.add_argument("--classnames", default=None, help="comma-separated override")
    p.add_argument("--out", required=True, help=".npy output path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    unknown = [m for m in args.templates.split(",") if m not in TEMPLATE_SETS]
    if unknown:
        p.error(f"unknown template set(s) {unknown}; have {sorted(TEMPLATE_SETS)}")
    return args


def main(argv: Sequence[str] = None) -> np.ndarray:
    """Write the bank to --out and return it."""
    args = parse_args(argv)
    device = device_or_raise(args.device)
    clip_cfg = AlphaClipConfig.vit_l_14_336()
    sd = load_openai_clip_state_dict(local_file(args.clip_ckpt, "--clip-ckpt"))
    entries, token_embedding, _ = convert_openai_clip(sd, clip_cfg)
    if token_embedding is None:
        raise KeyError(f"--clip-ckpt {args.clip_ckpt}: no token_embedding.weight")
    text_state = {k[len(CLIP_TEXT):]: v for k, v in entries.items() if k.startswith(CLIP_TEXT)}
    encode_prompts = make_encoder(build_text_tower(clip_cfg, text_state, device),
                                  token_embedding)
    if args.classnames:
        names = args.classnames.split(",")
    else:
        names = TRAIN_CLASS_NAMES if args.split == "train" else TEST_CLASS_NAMES
    modes = args.templates.split(",")
    banks = []
    for mode in ENSEMBLE_ORDER:
        if mode == "__gpt__" and args.gpt_json:
            banks.append(encode_gpt_bank(encode_prompts, names, args.gpt_json))
            print("[bank] encoded CuPL-GPT prompts", flush=True)
        elif mode in modes:
            banks.append(encode_text_features(encode_prompts, names, TEMPLATE_SETS[mode]))
            print(f"[bank] encoded {mode} ({len(TEMPLATE_SETS[mode])} templates)", flush=True)
    bank = combine_banks(banks)
    np.save(args.out, bank)
    print(f"wrote {bank.shape} bank to {args.out}", flush=True)
    return bank


if __name__ == "__main__":
    main()
