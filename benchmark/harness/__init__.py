"""The benchmark's general code: the run (core), the traffic generator, the
counts of work and the peaks, the trace reduction and the comparison that
decides ``correct``. Nothing here imports the program at module level;
drivers under ``drivers/`` bind it to ``parc_torch``."""
