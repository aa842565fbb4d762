"""The offline preprocessing (raw drop -> ml_ready or legacy h5): the port
of ``gssd_tpu/preprocessing``, numpy and OpenCV on the host."""

from gssd_torch.preprocessing.windowing import (  # noqa: F401
    apply_window,
    ircadb_window,
    normalize01,
    window_and_normalize,
)
from gssd_torch.preprocessing.mask2bbox import (  # noqa: F401
    mask_slice_to_boxes,
    volume_to_samples,
)
from gssd_torch.preprocessing.volume_io import (  # noqa: F401
    canonicalize_nii_orientation,
    dump_volume_slices,
    load_nii_volume,
    load_vtk_mesh_points,
)
