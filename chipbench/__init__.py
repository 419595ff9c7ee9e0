"""chipbench — the benchmark of the PyTorch/CUDA port (``repro_torch``).

One run scores one cell of ``BENCHMARK.json`` once on an NVIDIA GPU:
``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  Everything that belongs to one configuration, traffic
mix or metric is a file of its own, found by the name in the manifest:

* ``configs/<config>.json`` — the sizes of a model; its ``model`` key
  names the model maker in ``models/`` and its ``dataset`` the row source in
  ``datasets/``;
* ``traffic/<mix>.json`` — the parameters that ``mix.py`` turns into
  calls;
* ``metrics/<metric>.py`` (or ``metrics/<quantity>.py`` for a metric
  named ``<quantity>.<split>``) — a reader with ``read(ctx)``.

The yardstick (``yardstick.py``), the plain reference (``reference/``)
and the input generators (``datasets/``, ``trainer.py``) live here so
that a change to the program cannot move them.  ``program.py`` is the
only module that imports ``repro_torch``; nothing here imports ``jax``
or the JAX package ``repro``.
"""
