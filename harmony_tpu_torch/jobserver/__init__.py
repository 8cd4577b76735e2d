"""In-process job server and job entities."""
