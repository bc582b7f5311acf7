"""The CLIP BPE tokenizer, shared with the JAX package.

`camouflaged_vlm_tpu/models/clip/tokenizer.py` is framework-free, but the
packages above it (`models/__init__.py`, `models/clip/__init__.py`) import
flax, so it is loaded here by file path. Its BPE vocabulary is the one under
`camouflaged_vlm_tpu/assets/`.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import camouflaged_vlm_tpu  # framework-free package root (no jax import)

_NAME = "camouflaged_vlm_tpu_torch._clip_tokenizer"
_PATH = Path(camouflaged_vlm_tpu.__file__).parent / "models" / "clip" / "tokenizer.py"


def _load():
    if _NAME not in sys.modules:
        spec = importlib.util.spec_from_file_location(_NAME, _PATH)
        module = importlib.util.module_from_spec(spec)
        sys.modules[_NAME] = module
        spec.loader.exec_module(module)
    return sys.modules[_NAME]


tokenize = _load().tokenize
