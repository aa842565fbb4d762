"""AP / IoBB evaluation of the port (``ap_iobb``)."""

from gssd_torch.eval.ap_iobb import (  # noqa: F401
    evaluate_detections,
    run_detection_eval,
    voc_ap,
)
