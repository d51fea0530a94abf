"""The benchmark's general machinery: the manifest, the traffic generator, the
seeded weights, the trace reduction, the table of peaks and the comparison
that decides ``correct``."""
