"""The traffic: one generator (``generate.py``) over data files of
parameters (``mixes/<name>.json``), and the frozen renderer it draws
frames with."""
