"""Per-layer metric readers: ``<family>.py`` reads every metric whose name
starts with ``<family>.`` from the traced window's context (``run.py``:
``attr`` the trace split of rank 0, ``attrs`` every rank's, ``units`` and
``wall_s`` the traced units of one rank and the host time of as many
units run just before them without the profiler, ``traced_wall_s`` the
host time of the traced ones, ``work`` one
unit's work from the yardstick's cost model, ``world`` the ranks,
``data_wait_s`` the time the step loop waited for its loader). A reader
returns a number, or None where its cell has nothing for it to read."""
