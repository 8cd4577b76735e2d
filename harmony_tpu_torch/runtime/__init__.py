"""Driver-side table lifecycle."""
