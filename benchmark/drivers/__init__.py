"""One driver module a traffic kind (``benchmark/traffic/<mix>.json``'s
``kind``): ``Driver(config, traffic, seed, device)`` with ``setup``,
``window(seconds)``, ``traced()``, ``release`` and ``check``. A new kind
is a new module here."""
