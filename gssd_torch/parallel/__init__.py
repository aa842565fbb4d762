"""Training several models side by side: the k folds of cross-validation
(``folds.py``); and one training across processes, one a card: the plan
(``mesh.py``, with the evaluation forward split over the ranks), the
launcher (``launch.py``) and the sums and gathers over the ranks
(``collectives.py``)."""

from gssd_torch.parallel.folds import (  # noqa: F401
    FoldMember, fold_mean, fold_seed, fold_train_step)
