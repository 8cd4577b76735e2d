"""Input data: the process-level data caches and the staging ring."""
