from ubresnet_tpu_torch.losses.pixelwise_nll import (  # noqa: F401
    pixelwise_weighted_nll,
    pixelwise_weighted_nll_from_logits,
)
