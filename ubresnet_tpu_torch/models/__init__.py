from ubresnet_tpu_torch.models.aspp_resnet import (  # noqa: F401
    ASPPResNet,
    ASPPResNetConfig,
    TrainASPPResNet,
)
from ubresnet_tpu_torch.models.blocks import (  # noqa: F401
    ASPP,
    ASPPCombine,
    BasicBlock,
    BatchNorm,
    Conv,
    ConvBN,
    DecoderBlock,
    Deconv2x,
    DoubleResNet,
    TrainASPP,
    TrainASPPCombine,
    TrainBasicBlock,
    TrainDecoderBlock,
    TrainDeconv2x,
    TrainDoubleResNet,
    fold_bn,
)
from ubresnet_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY,
    arch_of,
    eval_class_of,
    get_model,
)
from ubresnet_tpu_torch.models.uresnet import (  # noqa: F401
    TrainUResNet,
    UResNet,
    UResNetConfig,
)
