"""The window's model operations (every batch served) over its seconds,
as a share of the bfloat16 peak."""

from metrics._shared import mfu as read  # noqa: F401
