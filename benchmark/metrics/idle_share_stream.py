"""Per cent of the traced segment of the stream cell with no kernel or
copy on the card (``torch.profiler`` over the traced batches)."""

from metrics._shared import idle_share as read  # noqa: F401
