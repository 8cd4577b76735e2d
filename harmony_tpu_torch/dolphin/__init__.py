"""The Dolphin training framework: trainer SPI, data provider, worker loop."""
