"""Phase timing."""
