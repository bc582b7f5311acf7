from .losses import (
    balanced_bce_with_logits,
    bce_with_logits,
    edge_dice_loss,
    segmentation_loss,
    soft_dice_loss,
    soft_iou_loss,
)
from .maple import (
    MAPLE_TRAINABLE_PREFIXES,
    maple_loss,
    maple_schedule,
    make_maple_optimizer,
    make_maple_train_step,
)
from .optim import (
    TRAINABLE_PREFIXES,
    cosine_epoch_schedule,
    make_optimizer,
    trainable_parameters,
)
from .train_step import SCANNED_BATCH_KEYS, make_train_step
