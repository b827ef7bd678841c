"""Launch helpers: the local mesh (:mod:`repro_torch.launch.mesh`)."""
