"""Training of the port: optimizer and LR schedule (``optim``), the
train, eval and inference steps (``steps``), checkpoints
(``checkpoint``) and the trainer CLI (``python -m gssd_torch.train``)."""

from gssd_torch.train.optim import make_optimizer, step_lr  # noqa: F401
from gssd_torch.train.steps import eval_step, train_step  # noqa: F401
from gssd_torch.train.trainer import main  # noqa: F401
