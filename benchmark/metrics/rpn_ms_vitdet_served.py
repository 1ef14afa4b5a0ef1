"""Median device milliseconds of the ViTDet stream's served batches'
``rpn`` stage (the ViT, the simple feature pyramid and the RPN head), read
as ``rpn_ms.served`` reads the R101 stream's."""

from metrics.rpn_ms_served import read  # noqa: F401
