"""The reference's checkpoints and JAX parameter trees -> the port's
`state_dict`, without JAX.

Counterpart of `camouflaged_vlm_tpu/io/convert.py`. The port's modules use
the reference's state-dict key names, so the reference layout *is* the
port's layout.

The reference's own files (`io/torch_loader.py` reads them) become the
port's keys by renames and key filters, no transposes: `convert_sam_backbone`
(the SAM `.pth`), `convert_openai_clip` (the OpenAI archive) and
`convert_maple_prompt_learner` (the dassl prompt learner) each return the
entries of the model they set, which `merge_into_state` copies into the
model with its shapes checked. Like the JAX converters they are not strict:
a key the file lacks leaves the model's weight as it is.

A JAX/flax param tree, given as a nested dict of numpy arrays, becomes a
state dict by the same key map as `export_cascade_checkpoint` and the same
inverse transforms:

  linear_w  kernel (in, out)           -> weight (out, in)
  conv_w    kernel (kh, kw, in, out)   -> weight (out, in, kh, kw)
  convT_w   kernel (kh, kw, out, in)   -> weight (in, out, kh, kw)
  row0      (D,)                       -> (1, D)
  direct    unchanged

`load_jax_params` loads the result with `strict=True`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models.cascade import CascadeConfig
from ..models.clip.model import AlphaClipConfig

KeyMapEntry = Tuple[str, str, str]  # (torch_key, flax_path, kind)


def _linear(tk: str, fp: str) -> List[KeyMapEntry]:
    return [(f"{tk}.weight", f"{fp}/kernel", "linear_w"), (f"{tk}.bias", f"{fp}/bias", "direct")]


def _ln(tk: str, fp: str) -> List[KeyMapEntry]:
    return [(f"{tk}.weight", f"{fp}/scale", "direct"), (f"{tk}.bias", f"{fp}/bias", "direct")]


def _conv(tk: str, fp: str, bias: bool = True) -> List[KeyMapEntry]:
    out = [(f"{tk}.weight", f"{fp}/kernel", "conv_w")]
    if bias:
        out.append((f"{tk}.bias", f"{fp}/bias", "direct"))
    return out


def _convT(tk: str, fp: str) -> List[KeyMapEntry]:
    return [(f"{tk}.weight", f"{fp}/kernel", "convT_w"), (f"{tk}.bias", f"{fp}/bias", "direct")]


def _proj_attn(tk: str, fp: str) -> List[KeyMapEntry]:
    out: List[KeyMapEntry] = []
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out += _linear(f"{tk}.{name}", f"{fp}/{name}")
    return out


def _sam_encoder_map(cfg: CascadeConfig) -> List[KeyMapEntry]:
    t, f = "image_encoder", "image_encoder"
    m: List[KeyMapEntry] = _conv(f"{t}.patch_embed.proj", f"{f}/patch_embed")
    m.append((f"{t}.pos_embed", f"{f}/pos_embed", "direct"))
    for i in range(cfg.encoder.depth):
        bt, bf = f"{t}.blocks.{i}", f"{f}/block_{i}"
        m += _ln(f"{bt}.norm1", f"{bf}/norm1") + _ln(f"{bt}.norm2", f"{bf}/norm2")
        m += _linear(f"{bt}.attn.qkv", f"{bf}/attn/qkv")
        m += _linear(f"{bt}.attn.proj", f"{bf}/attn/proj")
        if cfg.encoder.use_rel_pos:
            m.append((f"{bt}.attn.rel_pos_h", f"{bf}/attn/rel_pos_h", "direct"))
            m.append((f"{bt}.attn.rel_pos_w", f"{bf}/attn/rel_pos_w", "direct"))
        m += _linear(f"{bt}.mlp.lin1", f"{bf}/mlp/lin1")
        m += _linear(f"{bt}.mlp.lin2", f"{bf}/mlp/lin2")
    m += _conv(f"{t}.neck.0", f"{f}/neck_conv1", bias=False)
    m += _ln(f"{t}.neck.1", f"{f}/neck_ln1")
    m += _conv(f"{t}.neck.2", f"{f}/neck_conv2", bias=False)
    m += _ln(f"{t}.neck.3", f"{f}/neck_ln2")
    pt, pf = f"{t}.prompt_generator", f"{f}/prompt_generator"
    m += _linear(f"{pt}.shared_mlp", f"{pf}/shared_mlp")
    m += _linear(f"{pt}.embedding_generator", f"{pf}/embedding_generator")
    for i in range(cfg.encoder.depth):
        m += _linear(f"{pt}.lightweight_mlp_{i}.0", f"{pf}/lightweight_mlp_{i}")
    m += _conv(f"{pt}.prompt_generator.proj", f"{pf}/handcrafted_embed")
    return m


def _mask_decoder_map(cfg: CascadeConfig) -> List[KeyMapEntry]:
    t, f = "mask_decoder", "mask_decoder"
    m: List[KeyMapEntry] = [
        (f"{t}.{tok}.weight", f"{f}/{tok}", "direct")
        for tok in ("iou_token", "mask_tokens", "edge_token")
    ]
    for i in range(cfg.decoder.transformer.depth):
        lt, lf = f"{t}.transformer.layers.{i}", f"{f}/transformer/layer_{i}"
        for attn in ("self_attn", "cross_attn_token_to_image", "cross_attn_token_to_cond",
                     "cross_attn_image_to_cond", "cross_attn_image_to_token"):
            m += _proj_attn(f"{lt}.{attn}", f"{lf}/{attn}")
        for norm in ("norm1", "norm2", "norm2_cond", "norm3", "norm4", "norm4_cond"):
            m += _ln(f"{lt}.{norm}", f"{lf}/{norm}")
        m += _linear(f"{lt}.mlp.lin1", f"{lf}/mlp/lin1")
        m += _linear(f"{lt}.mlp.lin2", f"{lf}/mlp/lin2")
    m += _proj_attn(f"{t}.transformer.final_attn_token_to_image",
                    f"{f}/transformer/final_attn_token_to_image")
    m += _ln(f"{t}.transformer.norm_final_attn", f"{f}/transformer/norm_final_attn")
    m += _convT(f"{t}.output_upscaling.0", f"{f}/upscale_conv1")
    m += _ln(f"{t}.output_upscaling.1", f"{f}/upscale_ln")
    m += _convT(f"{t}.output_upscaling.3", f"{f}/upscale_conv2")
    m += _convT(f"{t}.embedding_encoder.0", f"{f}/edge_encoder_conv1")
    m += _ln(f"{t}.embedding_encoder.1", f"{f}/edge_encoder_ln")
    m += _convT(f"{t}.embedding_encoder.3", f"{f}/edge_encoder_conv2")
    m += _convT(f"{t}.embedding_maskfeature.0", f"{f}/maskfeature_conv1")
    m += _ln(f"{t}.embedding_maskfeature.1", f"{f}/maskfeature_ln")
    m += _convT(f"{t}.embedding_maskfeature.3", f"{f}/maskfeature_conv2")
    for i in range(cfg.decoder.num_mask_tokens - 1):
        for j in range(3):
            m += _linear(f"{t}.output_hypernetworks_mlps.{i}.layers.{j}",
                         f"{f}/hyper_mlp_{i}/layer_{j}")
    for j in range(3):
        m += _linear(f"{t}.edge_mlp.layers.{j}", f"{f}/edge_mlp/layer_{j}")
        m += _linear(f"{t}.iou_prediction_head.layers.{j}", f"{f}/iou_prediction_head/layer_{j}")
    return m


def _clip_map(clip: AlphaClipConfig) -> List[KeyMapEntry]:
    vt, vf = "clip_model.image_encoder", "clip_model/image_encoder"
    m: List[KeyMapEntry] = [
        (f"{vt}.conv1.weight", f"{vf}/conv1/kernel", "conv_w"),
        (f"{vt}.conv1_alpha.weight", f"{vf}/conv1_alpha/kernel", "conv_w"),
        (f"{vt}.class_embedding", f"{vf}/class_embedding", "direct"),
        (f"{vt}.positional_embedding", f"{vf}/positional_embedding", "direct"),
    ]
    m += _ln(f"{vt}.ln_pre", f"{vf}/ln_pre") + _ln(f"{vt}.ln_post", f"{vf}/ln_post")
    m.append((f"{vt}.proj", f"{vf}/proj", "direct"))
    for i in range(clip.vision_layers):
        bt, bf = f"{vt}.transformer.resblocks.{i}", f"{vf}/resblock_{i}"
        m += _linear(f"{bt}.attn.in_proj", f"{bf}/attn/in_proj")
        m += _linear(f"{bt}.attn.out_proj", f"{bf}/attn/out_proj")
        m += _ln(f"{bt}.ln_1", f"{bf}/ln_1") + _ln(f"{bt}.ln_2", f"{bf}/ln_2")
        m += _linear(f"{bt}.mlp.c_fc", f"{bf}/mlp/c_fc")
        m += _linear(f"{bt}.mlp.c_proj", f"{bf}/mlp/c_proj")
    tt, tf = "clip_model.text_encoder", "clip_model/text_encoder"
    m.append((f"{tt}.positional_embedding", f"{tf}/positional_embedding", "direct"))
    m += _ln(f"{tt}.ln_final", f"{tf}/ln_final")
    m.append((f"{tt}.text_projection", f"{tf}/text_projection", "direct"))
    for i in range(clip.transformer_layers):
        bt, bf = f"{tt}.transformer.resblocks.{i}", f"{tf}/resblock_{i}"
        m.append((f"{bt}.attn.in_proj_weight", f"{bf}/attn/in_proj/kernel", "linear_w"))
        m.append((f"{bt}.attn.in_proj_bias", f"{bf}/attn/in_proj/bias", "direct"))
        m += _linear(f"{bt}.attn.out_proj", f"{bf}/attn/out_proj")
        m += _ln(f"{bt}.ln_1", f"{bf}/ln_1") + _ln(f"{bt}.ln_2", f"{bf}/ln_2")
        m += _linear(f"{bt}.mlp.c_fc", f"{bf}/mlp/c_fc")
        m += _linear(f"{bt}.mlp.c_proj", f"{bf}/mlp/c_proj")
    m.append(("clip_model.logit_scale", "clip_model/logit_scale", "direct"))
    pt, pf = "clip_model.prompt_learner", "clip_model/prompt_learner"
    m.append((f"{pt}.ctx", f"{pf}/ctx", "direct"))
    m += _linear(f"{pt}.proj", f"{pf}/proj")
    for i in range(clip.prompt_depth - 1):
        m.append((f"{pt}.compound_prompts_text.{i}", f"{pf}/compound_prompts_text_{i}", "direct"))
        m += _linear(f"{pt}.compound_prompt_projections.{i}", f"{pf}/compound_prompt_proj_{i}")
    return m


def cascade_key_map(cfg: CascadeConfig) -> List[KeyMapEntry]:
    """Every parameter of the cascade: (state-dict key, flax path, transform)."""
    m = _sam_encoder_map(cfg) + _mask_decoder_map(cfg)
    m.append(("no_mask_embed.weight", "no_mask_embed", "row0"))
    m.append(("pe_layer.positional_encoding_gaussian_matrix",
              "pe_layer/positional_encoding_gaussian_matrix", "direct"))
    m += _ln("sam_visual_proj.0", "visual_proj_ln1")
    m += _linear("sam_visual_proj.1", "visual_proj_dense")
    m += _ln("sam_visual_proj.2", "visual_proj_ln2")
    m += _ln("sam_text_proj.0", "text_proj_ln")
    m += _linear("sam_text_proj.1", "text_proj_dense")
    return m + _clip_map(cfg.clip)


def _inverse_transform(kind: str, v: np.ndarray) -> np.ndarray:
    if kind == "linear_w":
        return np.ascontiguousarray(v.T)
    if kind in ("conv_w", "convT_w"):
        return np.ascontiguousarray(v.transpose(3, 2, 0, 1))
    if kind == "row0":
        return np.ascontiguousarray(v.reshape(1, -1))
    if kind == "direct":
        return np.ascontiguousarray(v).reshape(v.shape)
    raise ValueError(f"unknown transform kind {kind!r}")


def state_dict_from_jax_params(params: Mapping, cfg: CascadeConfig) -> Dict[str, torch.Tensor]:
    """Flax cascade params (the variables dict or its 'params' collection,
    nested dicts of numpy arrays) -> the port's fp32 state dict. Raises on
    any mapped parameter missing from the tree."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for tk, fp, kind in cascade_key_map(cfg):
        node = tree
        for k in fp.split("/"):
            if k not in node:
                raise KeyError(f"param tree missing {fp}")
            node = node[k]
        v = np.asarray(node, dtype=np.float32)
        sd[tk] = torch.from_numpy(_inverse_transform(kind, v))
    return sd


def load_jax_params(model: nn.Module, params: Mapping, cfg: CascadeConfig) -> None:
    """Load flax cascade params into the port's model (strict)."""
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)


# ------------------------------------------- the reference's files -> the port


# (the port's key, the file's key) of each entry a converter reads
KeyPair = Tuple[str, str]

CLIP_VISION = "clip_model.image_encoder."
CLIP_TEXT = "clip_model.text_encoder."
PROMPT_LEARNER = "clip_model.prompt_learner."


def sam_backbone_keys(cfg: CascadeConfig) -> List[str]:
    """The keys `sam_vit_h_4b8939.pth` can set, which the reference loads
    with strict=False (`train_ovcos_maskdecoder_edge.py:296-299`): the whole
    encoder map, and the stock decoder's entries that the edge decoder shares
    by name (no `cond`, `edge` or `embedding_` entries)."""
    stock = [e for e in _mask_decoder_map(cfg)
             if "cond" not in e[0] and "edge" not in e[0] and "embedding_" not in e[0]]
    return [tk for tk, _, _ in _sam_encoder_map(cfg) + stock]


def openai_clip_pairs(clip: AlphaClipConfig, in_proj_renamed: bool) -> List[KeyPair]:
    """The port's CLIP tower keys and their names in an OpenAI state dict:
    `visual.*` for the vision tower (its fused attention weights named
    `in_proj_weight`, or `in_proj.weight` in the form the reference renames
    them to, `alpha_clip_rw/model.py:864-874`), the text tower's keys bare,
    and `logit_scale`. Not the prompt learner."""
    out: List[KeyPair] = []
    for tk, _, _ in _clip_map(clip):
        if tk.startswith(CLIP_VISION):
            fk = "visual." + tk[len(CLIP_VISION):]
            if not in_proj_renamed:
                fk = fk.replace("attn.in_proj.weight", "attn.in_proj_weight").replace(
                    "attn.in_proj.bias", "attn.in_proj_bias")
            out.append((tk, fk))
        elif tk.startswith(CLIP_TEXT):
            out.append((tk, tk[len(CLIP_TEXT):]))
        elif tk == "clip_model.logit_scale":
            out.append((tk, "logit_scale"))
    return out


def maple_pairs(clip: AlphaClipConfig, prefix: str) -> List[KeyPair]:
    """The prompt learner's keys and their names in a dassl state dict,
    `prompt_learner.ctx` (prefix 'prompt_learner') or bare `ctx` ('')."""
    head = f"{prefix}." if prefix else ""
    return [(tk, head + tk[len(PROMPT_LEARNER):]) for tk, _, _ in _clip_map(clip)
            if tk.startswith(PROMPT_LEARNER)]


def _rename(sd: Mapping[str, torch.Tensor], pairs) -> Tuple[Dict[str, torch.Tensor],
                                                            List[str]]:
    """The file's entries under the port's keys, and the file keys absent."""
    out, missing = {}, []
    for tk, fk in pairs:
        if fk in sd:
            out[tk] = sd[fk]
        else:
            missing.append(fk)
    return out, missing


def convert_sam_backbone(sd: Mapping[str, torch.Tensor], cfg: CascadeConfig):
    """A SAM backbone state dict -> (the port's entries it sets, missing
    keys). Its other keys (`prompt_encoder.*`, ...) are ignored."""
    return _rename(sd, [(k, k) for k in sam_backbone_keys(cfg)])


def convert_openai_clip(sd: Mapping[str, torch.Tensor], clip: AlphaClipConfig):
    """An OpenAI (or Alpha-CLIP) state dict -> (the port's CLIP tower
    entries, `token_embedding.weight` as fp32 numpy or None, missing keys),
    with the reference's surgeries (`alpha_clip_rw/model.py:864-881`):
    either in-proj naming; `conv1_alpha` made of zeros when absent."""
    sd = dict(sd)
    if "visual.conv1_alpha.weight" not in sd and "visual.conv1.weight" in sd:
        sd["visual.conv1_alpha.weight"] = torch.zeros_like(sd["visual.conv1.weight"][:, 0:1])
    renamed = any("in_proj.weight" in k for k in sd)
    out, missing = _rename(sd, openai_clip_pairs(clip, renamed))
    tok = sd.get("token_embedding.weight")
    return out, (tok.detach().float().numpy() if tok is not None else None), missing


def convert_maple_prompt_learner(sd: Mapping[str, torch.Tensor], clip: AlphaClipConfig):
    """A dassl MaPLe state dict, wrapped (`prompt_learner.*`) or bare ->
    (the port's prompt-learner entries, missing keys), without the
    token_prefix/suffix buffers (`models/sam_maskdecoder_edge.py:192-201`).
    Raises ValueError when no key matches: the model would run on random
    prompts."""
    sd = {k: v for k, v in sd.items() if not k.endswith(
        ("token_prefix", "token_suffix", "token_prefix_test", "token_suffix_test"))}
    prefix = "prompt_learner" if any(k.startswith("prompt_learner") for k in sd) else ""
    out, missing = _rename(sd, maple_pairs(clip, prefix))
    if not out:
        raise ValueError("MaPLe checkpoint matched no prompt-learner keys: the model would "
                         f"run with random prompts. Checkpoint keys: {sorted(sd)[:6]}...")
    return out, missing


def merge_into_state(model: nn.Module, entries: Mapping[str, torch.Tensor]) -> int:
    """Copy converted entries into the model's parameters and buffers, one
    tensor at a time, each cast to the type the model holds it in. Raises
    KeyError for a key the model lacks and ValueError for a shape that
    differs, before anything is copied. Returns the number copied."""
    own = model.state_dict(keep_vars=True)
    for k, v in entries.items():
        if k not in own:
            raise KeyError(f"converted entry {k} not in the model")
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)} vs model "
                             f"{tuple(own[k].shape)}")
    with torch.no_grad():
        for k, v in entries.items():
            own[k].copy_(v)
    return len(entries)


def reference_state_dict(model_sd: Mapping[str, torch.Tensor], cfg: CascadeConfig,
                         strict: bool = False) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The port's state dict -> the reference's `model.state_dict()` layout
    in fp32 (`cascade_key_map`'s entries, in its order), and the keys
    absent; `strict` raises on the first. The counterpart of
    `export_cascade_checkpoint`."""
    out: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    for tk, _, _ in cascade_key_map(cfg):
        if tk in model_sd:
            out[tk] = model_sd[tk].detach().to("cpu", torch.float32).contiguous()
        elif strict:
            raise KeyError(f"state dict missing {tk}")
        else:
            missing.append(tk)
    return out, missing
