"""Median device milliseconds of the MViTv2 stream's served batches'
``rpn`` stage (the MViT, the FPN and the RPN head), read as
``rpn_ms.served`` reads the R101 stream's."""

from metrics.rpn_ms_served import read  # noqa: F401
