"""Training substrate — the counterpart of ``repro.distributed``:
checkpoints (``checkpoint``), Adam with f32 or int8 moments
(``optimizer``), int8 error-feedback gradient compression
(``compression``, with ``compressed_psum`` over a mesh axis), fault
tolerance (``fault_tolerance``) and the sharding rules (``sharding``).
Splitting stored tensors by those rules (tensor parallelism, FSDP) is
ROADMAP Queue A 12.7; training runs data parallel
(``launch/train.py``)."""
