"""Job, trainer and table configuration."""
