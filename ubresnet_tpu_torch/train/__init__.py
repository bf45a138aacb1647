from ubresnet_tpu_torch.train.checkpoint import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from ubresnet_tpu_torch.train.metrics import (  # noqa: F401
    AverageMeter,
    pixel_accuracy,
)
from ubresnet_tpu_torch.train.optimizers import make_optimizer  # noqa: F401
from ubresnet_tpu_torch.train.schedules import make_schedule  # noqa: F401
from ubresnet_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    build_eval_step,
    build_train_step,
    create_train_state,
)
