from repro_torch.train.optimizer import adafactor, adamw  # noqa: F401
from repro_torch.train.trainer import make_train_step  # noqa: F401
