from .model import AlphaClipConfig, AlphaClipVisionTower, ClipTextTower, build_causal_mask
from .prompt_learner import ClassPromptBank, MultiModalPromptLearner, build_class_prompt_bank
from .custom_clip import CustomClip
from .tokenizer import tokenize
