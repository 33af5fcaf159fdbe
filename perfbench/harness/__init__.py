"""The benchmark's own machinery: the frozen data generator, the trace
reduction, the peaks and the comparison that decides ``correct``.  Nothing
here imports the measured package; ``drivers/`` does."""
