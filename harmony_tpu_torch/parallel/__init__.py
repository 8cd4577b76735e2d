"""Device pool and placement."""
