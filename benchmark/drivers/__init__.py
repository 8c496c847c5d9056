"""One driver a kind of path. Each module offers ``run(r)``, which takes a
``harness.Run`` and returns what the run measured (its end-to-end metrics
or its traced window), its peak memory and the numbers ``correct``
compares; ``program(run, tree)``, the system under test; ``work(r)``, one
unit's work by the configuration's work model; ``Control``, the plain
reference in TF32 offering the calls the driver makes of the program; and
``FAULTS`` (with ``RANK_FAULTS`` where it runs over several ranks), the
planted faults of ``faults.py`` its cell can have."""
