"""Training substrate — the counterpart of ``repro.distributed``:
checkpoints (``checkpoint``), Adam with f32 or int8 moments
(``optimizer``), int8 error-feedback gradient compression
(``compression``, with ``compressed_psum`` over a mesh axis), fault
tolerance (``fault_tolerance``), the sharding rules and each rank's
shards under them (``sharding``), and the autograd-aware collectives and
tensor-parallel context the trainer's model runs under on a mesh
(``collectives``, ``launch/train.py``)."""
