"""Core of the over-the-air aggregation: channel, compression, projection, AMP, schemes."""
