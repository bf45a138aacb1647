from ubresnet_tpu_torch.deploy.precropped import PrecroppedRunner  # noqa: F401
from ubresnet_tpu_torch.deploy.wholeview import WholeViewRunner  # noqa: F401
from ubresnet_tpu_torch.deploy.weights import (  # noqa: F401
    load_reference_checkpoint,
    quant_scales_from_jax,
    random_state_dict,
    save_reference_checkpoint,
    state_dict_from_jax,
)
