"""End-to-end metrics, one reader a file, named as the metric: ``read(run)``
takes the harness's :class:`gpubench.harness.Run` record of a run and
returns the metric's value (None where the cell's loop has no such
number)."""
