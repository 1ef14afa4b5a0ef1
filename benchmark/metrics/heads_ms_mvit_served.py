"""Median device milliseconds of the MViTv2 stream's served batches from
the ``rpn`` mark to the ``maskhead`` mark (proposals, the box pool, the
R-FPN box head, NMS, the mask pool and the mask head), read as
``heads_ms.served`` reads the R101 stream's."""

from metrics.heads_ms_served import read  # noqa: F401
