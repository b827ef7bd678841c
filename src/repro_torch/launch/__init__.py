"""Launch helpers: the local mesh (:mod:`repro_torch.launch.mesh`) and the
training driver (``python -m repro_torch.launch.train``)."""
