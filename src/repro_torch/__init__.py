"""repro_torch — the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The same packages as ``repro`` (``trees``, ``data``, ``core``, ``optim``, ``io``,
``cascade``, ``kernels``, ``inference``, and for the LM stack ``models``
and ``configs``), so each module's counterpart sits at the same path.
The port imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.

Backends map one to one onto the reference's:

    repro backend="jax"     (the XLA engines)    ->  backend="torch"
    repro backend="pallas"  (the Pallas kernels) ->  backend="cuda"
        bitvector: qs_forward        (kernels/csrc/qs_forward.cu)
        bitmm:     qs_bitmm_forward  (kernels/csrc/qs_bitmm_forward.cu)
        gemm:      gemm_forward      (kernels/csrc/gemm_forward.cu)
        bitvector cascade, fused:
                   cascade_qs_forward (kernels/csrc/cascade_qs_forward.cu)
        LM attention (``models.Model(..., backend=...)``; the reference
        model's own attention is its XLA chunked flash, which the port's
        ``torch`` backend follows):
                   flash_forward     (kernels/csrc/flash_forward.cu)

Entry points run on the card unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit ``device`` they raise.
"""
