from ubresnet_tpu_torch.models.blocks import (  # noqa: F401
    BasicBlock,
    BatchNorm,
    Conv,
    ConvBN,
    DecoderBlock,
    Deconv2x,
    DoubleResNet,
    TrainBasicBlock,
    TrainDecoderBlock,
    TrainDeconv2x,
    TrainDoubleResNet,
    fold_bn,
)
from ubresnet_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY,
    get_model,
)
from ubresnet_tpu_torch.models.uresnet import (  # noqa: F401
    TrainUResNet,
    UResNet,
    UResNetConfig,
)
