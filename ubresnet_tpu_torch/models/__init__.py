from ubresnet_tpu_torch.models.blocks import (  # noqa: F401
    BasicBlock,
    ConvBN,
    DecoderBlock,
    Deconv2x,
    DoubleResNet,
    fold_bn,
)
from ubresnet_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY,
    get_model,
)
from ubresnet_tpu_torch.models.uresnet import (  # noqa: F401
    UResNet,
    UResNetConfig,
)
