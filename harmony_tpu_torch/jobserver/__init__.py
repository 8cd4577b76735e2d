"""The job server (in process, and over its TCP command plane), its client,
overload control and the job entities."""
