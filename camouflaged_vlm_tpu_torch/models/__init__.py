from .cascade import CascadeConfig, OVCOSCascade
from .mask_decoder import EdgeMaskDecoder, MaskDecoderConfig
from .sam_encoder import ImageEncoderViT, SamEncoderConfig
from .two_way_transformer import TwoWayTransformerConfig
