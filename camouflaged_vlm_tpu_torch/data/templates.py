"""Prompt template sets for text-feature bank precomputation.

A copy of `camouflaged_vlm_tpu/data/templates.py` (the port imports nothing
of the JAX package; `tests/test_torch_text_bank.py` holds the copy equal).

CAMO_PROMPTS: the six camouflage templates of the shipped Train/Test
text-feature banks (the reference's `models/sam_maskdecoder_edge.py:23-30`,
`cocotrainers/alphaCLIP.py:148-163`).

IMAGENET_TEMPLATES: the standard 80-template OpenAI CLIP ensembling set (the
reference's `templates/imagenet_templates.py` carries the same public list),
the precompute CLI's `--templates imagenet80`.
"""

CAMO_PROMPTS = [
    "A photo of the camouflaged {}.",
    "A photo of the concealed {}.",
    "A photo of the {} camouflaged in the background.",
    "A photo of the {} concealed in the background.",
    "A photo of the {} camouflaged to blend in with its surroundings.",
    "A photo of the {} concealed to blend in with its surroundings.",
]

IMAGENET_TEMPLATES = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.", "the embroidered {}.",
    "a photo of a hard to see {}.", "a bright photo of a {}.",
    "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.", "the origami {}.",
    "the {} in a video game.", "a sketch of a {}.", "a doodle of the {}.",
    "a origami {}.", "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.",
    "a photo of a nice {}.", "a photo of a weird {}.",
    "a blurry photo of a {}.", "a cartoon {}.", "art of a {}.",
    "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.", "a photo of the small {}.",
    "a photo of the weird {}.", "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.", "graffiti of the {}.",
    "a toy {}.", "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
]

# Attribute/augmentation context templates (public list; the reference's
# `templates/mapper_data.py` `ctx_templates`, consumed by the bank builder's
# USE_ATTRIBUTE_DATA mode, `cocotrainers/alphaCLIP.py:224-244`).
ATTRIBUTE_TEMPLATES = [
    "a photo of a {}.",
    "a photo of a {}, upside-down.",
    "a photo of a {}, the photo is upside-down.",
    "a photo of a {}, the photo is upright.",
    "a photo of a {}, rotated.",
    "a photo of a {}, the photo is rotated.",
    "a photo of a {}, upright.",
    "a photo of a {}, distorted.",
    "a photo of a {}, the photo is distorted.",
    "a photo of a {}, color-inverted.",
    "a photo of a {}, the photo is color-inverted.",
    "a photo of a {}, solarized.",
    "a photo of a {}, the photo is solarized.",
    "a photo of a {}, normal.",
    "a photo of a {}, the photo is normal.",
    "a photo of a {}, blurred.",
    "a photo of a {}, the photo is blurred.",
    "a photo of a {}, grayscale.",
    "a photo of a {}, the photo is in black and white.",
    "a photo of a {}, colorful.",
    "a photo of a {}, the photo is colorful.",
    "a photo of a {}, bright.",
    "a photo of a {}, the photo is bright.",
    "a photo of a {}, dark.",
    "a photo of a {}, the photo is dark.",
    "a photo of a {}, with noise.",
    "a photo of a {}, the photo has noise.",
    "a photo of a {}, in the snow.",
    "a photo of a {}, the photo is in the snow.",
    "a photo of a {}, in the frost.",
    "a photo of a {}, the photo is in the frost.",
    "a photo of a {}, in the fog.",
    "a photo of a {}, the photo is in the fog.",
    "a photo of a {}, clear.",
    "a photo of a {}, the photo is clear.",
    "a photo of a {}, in jpeg format.",
    "a photo of a {}, the photo is in jpeg format.",
    "a photo of a {}, in high resolution.",
    "a photo of a {}, the photo is in high resolution.",
    "a photo of a {}, upside-down, color-inverted.",
    "a photo of a {}, the photo is upside-down, color-inverted.",
    "a photo of a {}, upright, normal.",
    "a photo of a {}, the photo is upright, normal.",
    "a photo of a {}, grayscale, with distortion.",
    "a photo of a {}, the photo is distorted, in black and white.",
    "a photo of a {}, colorful, normal.",
    "a photo of a {}, the photo is colorful, normal.",
]

TEMPLATE_SETS = {
    "camoprompts": CAMO_PROMPTS,
    "imagenet80": IMAGENET_TEMPLATES,
    "attributes": ATTRIBUTE_TEMPLATES,
}
