"""YAML -> the port's config dataclasses.

Counterpart of `camouflaged_vlm_tpu/config.py`: `cascade_config_from_yaml`
reads both formats the JAX package reads, the native re-keyed one
(`configs/*.yaml`, and the port's own `camouflaged_vlm_tpu_torch/configs/`)
and the reference's own (auto-detected by its `model.args` nesting), into
the same configuration with torch dtypes.

Keys of the JAX configs that the port has no field for load only where they
change nothing here, and raise otherwise; nothing is dropped silently:

  clip.fused     true loads (the port's CLIP always runs its kernels on the
                 card); false (the JAX package's pure-XLA CLIP) raises
                 NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import yaml

from .models import CascadeConfig, MaskDecoderConfig, SamEncoderConfig
from .models.clip import AlphaClipConfig
from .models.two_way_transformer import TwoWayTransformerConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# JAX-only keys, each with the one value the port takes
_JAX_ONLY = {
    AlphaClipConfig: {"fused": (True, "fused: false (the JAX package's pure-XLA CLIP) has no "
                                      "counterpart in the port")},
}


def _build(dc_cls, spec: Dict[str, Any], **extra):
    fields = {f.name for f in dataclasses.fields(dc_cls)}
    spec = dict(spec or {})
    for key, (ok, why) in _JAX_ONLY.get(dc_cls, {}).items():
        if key in spec and spec.pop(key) != ok:
            raise NotImplementedError(f"{dc_cls.__name__}: {why}")
    unknown = set(spec) - fields - set(extra)
    if unknown:
        raise KeyError(f"unknown {dc_cls.__name__} keys: {sorted(unknown)}")
    kwargs = {k: v for k, v in spec.items() if k in fields}
    kwargs.update(extra)
    if "global_attn_indexes" in kwargs:
        kwargs["global_attn_indexes"] = tuple(kwargs["global_attn_indexes"])
    return dc_cls(**kwargs)


def _from_reference_yaml(raw: Dict[str, Any]) -> Tuple[CascadeConfig, Dict[str, Any]]:
    """The reference's own config format (its `model.args` plumbing) ->
    (CascadeConfig, train hyperparameters), as the JAX package maps it:
    bfloat16 and 'flash'; any EVP variant but the implemented one raises."""
    m = raw["model"]["args"]
    enc = dict(m.get("encoder_mode", {}))
    for key, want in (("name", "sam"), ("input_type", "fft"),
                      ("prompt_type", "highpass"), ("tuning_stage", 1234),
                      ("handcrafted_tune", True), ("embedding_tune", True),
                      ("adaptor", "adaptor"), ("qkv_bias", True)):
        got = enc.get(key, want)
        if got != want:
            raise ValueError(
                f"reference config encoder_mode.{key}={got!r}: only {want!r} is implemented"
            )
    dtype = torch.bfloat16
    enc_spec = dict(
        img_size=enc.get("img_size", 1024),
        patch_size=enc.get("patch_size", 16),
        embed_dim=enc.get("embed_dim", 1280),
        depth=enc.get("depth", 32),
        num_heads=enc.get("num_heads", 16),
        mlp_ratio=float(enc.get("mlp_ratio", 4)),
        out_chans=enc.get("out_chans", 256),
        window_size=enc.get("window_size", 14),
        global_attn_indexes=tuple(enc.get("global_attn_indexes", (7, 15, 23, 31))),
        use_rel_pos=enc.get("use_rel_pos", True),
        prompt_scale_factor=enc.get("scale_factor", 32),
        freq_rate=enc.get("freq_nums", 0.25),
    )
    maple = (raw.get("MAPLE_ALPHA_CLIP") or {}).get("TRAINER", {}).get("MAPLE", {})
    clip_spec = {}
    if "N_CTX" in maple:
        clip_spec["n_ctx"] = maple["N_CTX"]
    if "PROMPT_DEPTH" in maple:
        clip_spec["prompt_depth"] = maple["PROMPT_DEPTH"]
    prompt_dim = enc.get("prompt_embed_dim", 256)
    clip_size = ((raw.get("MAPLE_ALPHA_CLIP") or {}).get("INPUT", {}).get("SIZE", [336]))[0]
    twt = _build(TwoWayTransformerConfig, {}, embedding_dim=prompt_dim, dtype=dtype)
    cfg = CascadeConfig(
        inp_size=m.get("inp_size", 1024),
        clip_size=clip_size,
        prompt_embed_dim=prompt_dim,
        encoder=_build(SamEncoderConfig, enc_spec, dtype=dtype),
        decoder=_build(MaskDecoderConfig, {"transformer_dim": prompt_dim},
                       transformer=twt, dtype=dtype),
        clip=_build(AlphaClipConfig, clip_spec, dtype=dtype),
    )
    train_hp = {
        "epochs": raw.get("epoch_max", 20),
        "lr": (raw.get("optimizer") or {}).get("args", {}).get("lr", 2e-4),
        "eta_min": raw.get("lr_min", 1e-7),
        "epoch_val": raw.get("epoch_val", 2),
        "batch_size": (raw.get("train_dataset") or {}).get("batch_size", 1),
        "loss": m.get("loss", "iou"),
    }
    return cfg, train_hp


def cascade_config_from_yaml(path: str) -> Tuple[CascadeConfig, Dict[str, Any]]:
    """(CascadeConfig, train-hyperparameter dict) from a native or a
    reference-format yaml."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    m = raw["model"]
    if "args" in m:
        return _from_reference_yaml(raw)
    dtype = DTYPES[m.get("dtype", "bfloat16")]
    dec_spec = dict(m.get("decoder", {}))
    twt_spec = dec_spec.pop("transformer", {})
    twt = _build(TwoWayTransformerConfig, twt_spec,
                 embedding_dim=dec_spec.get("transformer_dim", 256), dtype=dtype)
    cfg = CascadeConfig(
        inp_size=m.get("inp_size", 1024),
        clip_size=m.get("clip_size", 336),
        prompt_embed_dim=dec_spec.get("transformer_dim", 256),
        encoder=_build(SamEncoderConfig, m.get("encoder", {}), dtype=dtype),
        decoder=_build(MaskDecoderConfig, dec_spec, transformer=twt, dtype=dtype),
        clip=_build(AlphaClipConfig, m.get("clip", {}), dtype=dtype),
    )
    return cfg, raw.get("train", {})


def with_dtype(cfg: CascadeConfig, dtype: torch.dtype) -> CascadeConfig:
    """`cfg` with every module's compute type set to `dtype` (the CLIs'
    `--dtype` overrides the yaml's)."""
    dec = cfg.decoder
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, dtype=dtype),
        decoder=dataclasses.replace(dec, dtype=dtype,
                                    transformer=dataclasses.replace(dec.transformer,
                                                                    dtype=dtype)),
        clip=dataclasses.replace(cfg.clip, dtype=dtype),
    )
