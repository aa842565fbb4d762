from gssd_torch.models.ssd import SSD, build_model, slice_and_cat  # noqa: F401
