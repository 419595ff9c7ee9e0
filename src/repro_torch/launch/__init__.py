"""repro_torch.launch — the port's launchers (``launch.serve``); the
counterpart of ``repro.launch``'s serving launcher."""
