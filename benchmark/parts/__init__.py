"""Parts: what a deployment runs beside the receiver.

A configuration names its parts (``"parts": ["gps"]``); the harness finds
each as ``parts/<name>.py`` and loads it by path.  A part module gives

- ``build(ctx) -> dict``: keyword arguments it adds to ``KiwiServer``
  (``gps=``, ``autorun=``, ...).  ``ctx`` holds ``cell``, ``cfg``,
  ``mix``, ``seed``, ``device``, ``plan`` and ``engine``; from then on
  also ``server``, once the listeners are in ``probes`` and ``loop``
  (the server's event loop), and after the run ``blocks`` (the window's first block and the block after its last)
  and ``window`` (its start and end on ``time.monotonic``);
- ``snapshot(ctx, n)`` (optional): called after the probes' snapshots of
  each sampled block ``n``, on the step's thread;
- ``numbers(ctx) -> dict``: ``{name: float}``, read once the server has
  stopped.  They join the run's numbers, each held to the limit of that
  name in the cell's ``reference/limits/<cell>.json``;
- ``NUMBERS``: the names ``numbers`` gives.  For each, a missing reading
  or a missing limit makes the run not correct;
- ``close(ctx)`` (optional): called after ``numbers``.

A part imports the program as the harness does, and nothing of JAX.
"""
