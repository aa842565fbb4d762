"""``python -m gssd_torch.train``: see ``gssd_torch.train.trainer``."""

from gssd_torch.train.trainer import main

if __name__ == "__main__":
    main()
