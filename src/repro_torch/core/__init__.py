"""Core of the over-the-air aggregation: channel, compression, projection, AMP, schemes."""
from repro_torch.core.schemes import (  # noqa: F401
    MACContext, PAPER_SCHEMES, Scheme, get_scheme, register_scheme,
    registered_schemes, round_sharded, round_simulated,
)
