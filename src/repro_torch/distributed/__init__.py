"""Training substrate — the counterpart of ``repro.distributed``:
checkpoints (``checkpoint``), Adam with f32 or int8 moments
(``optimizer``), int8 error-feedback gradient compression
(``compression``) and fault tolerance (``fault_tolerance``).  The sharding
rules and the data-parallel all-reduce wait for ROADMAP Queue A 12.6."""
