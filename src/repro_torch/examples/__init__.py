"""repro_torch.examples: the reference's examples on the port, each run as
``python -m repro_torch.examples.<name>``, on the card unless ``main`` is
given ``device="cpu"``."""
