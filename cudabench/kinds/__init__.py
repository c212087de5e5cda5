"""One module per kind of work a traffic mix drives: ``enrol``,
``identify``, ``all_pairs``. Each has ``program()``, the port's entry
points it calls, and ``Work(config, traffic, seed, device, program)``
with ``warm_up``, ``window``, ``traced``, ``counts``, ``release`` and
``compare``; every size it uses comes from the configuration's and the
mix's files."""
