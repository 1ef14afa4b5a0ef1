"""Traffic drivers, one module per driver, named by a cell's ``traffic``.

A driver has ``setup(cell, seed)`` (-> its state; ``state["reference_s"]``,
the seconds that set-up spent in the reference, which ``setup_s`` leaves
out), ``window(state, seconds)`` (-> the
end-to-end metrics and the records the per-layer readers take),
``traced(state)`` (the segment the profiler watches in a ``--trace 1``
run), ``after_trace(state, records)``, ``release(state)`` (frees the
program's state before the reference runs), ``judge(state)`` (-> the numbers
compared and their limits) and ``close(state)``."""
