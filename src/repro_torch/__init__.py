"""repro_torch — the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The same packages as ``repro`` (``trees``, ``data``, ``core``, ``kernels``,
``inference``), so each module's counterpart sits at the same path.  The
port imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Backends map one to one onto the reference's:

    repro backend="jax"     (eval_batch, XLA)    ->  backend="torch"
    repro backend="pallas"  (qs_forward kernel)  ->  backend="cuda"
                                                      (kernels/csrc/qs_forward.cu)

Entry points run on the card unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit ``device`` they raise.
"""
