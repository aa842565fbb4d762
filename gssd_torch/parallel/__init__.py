"""Training several models side by side: the k folds of cross-validation
(``folds.py``)."""

from gssd_torch.parallel.folds import (  # noqa: F401
    FoldMember, fold_mean, fold_seed, fold_train_step)
